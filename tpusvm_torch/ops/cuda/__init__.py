"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

fused_fupdate: the blocked solver's f-update, sum_k coef_k K(x_i, xb_k).
inner_smo:     the whole working-set subproblem in one launch.
pair_rows:     the pair solver's K-row refresh, skipped on the card when
               no row's index changed.

Each wrapper sends a CPU tensor to its plain torch version and a CUDA
tensor to its kernel (or raises), and counts its kernel launches in a
plain integer attribute, `<wrapper>.launches`.
"""
