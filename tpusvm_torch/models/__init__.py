"""Estimators and their artifact format."""

from tpusvm_torch.models.svm import BinarySVC

__all__ = ["BinarySVC"]
