"""Solvers: the analytic pair update, the blocked working-set solver and
batched prediction."""
