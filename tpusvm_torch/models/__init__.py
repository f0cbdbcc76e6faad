"""Estimators and their artifact format."""

from tpusvm_torch.models.ovr import OneVsRestSVC
from tpusvm_torch.models.serialization import load_model, model_task, save_model
from tpusvm_torch.models.svm import BinarySVC
from tpusvm_torch.models.svr import EpsilonSVR


def load_any(path: str, device="cuda"):
    """Load any saved artifact with the right estimator class: OvR states
    carry `classes`, SVR states a `task` marker, everything else (every v1
    file too) is a BinarySVC."""
    kind = model_task(path)
    cls = {"ovr": OneVsRestSVC, "svr": EpsilonSVR}.get(kind, BinarySVC)
    return cls.load(path, device=device)


__all__ = ["BinarySVC", "OneVsRestSVC", "EpsilonSVR", "save_model",
           "load_model", "load_any", "model_task"]
