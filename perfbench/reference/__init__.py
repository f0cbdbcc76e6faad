"""The plain reference: min-max scaling, an RBF C-SVC solver and the
judge of a solve, in NumPy and plain PyTorch operations. It imports
nothing of the program under test, takes nothing the program made, and
computes in float64 on float32 feature values (the configuration's
float32 features with float64 accumulators), or, for the controls, one
step below (reference/svm.py: precision "bf16" or "tf32")."""
