"""Compute primitives: RBF contractions, index-set masks, CUDA kernels."""
