"""train_s: the window's seconds over the units of work (fits) it
completed, back to back, on the host's clock."""


def read(run):
    return run.window_s / run.n_units if run.n_units else None
