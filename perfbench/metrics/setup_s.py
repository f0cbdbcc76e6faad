"""setup_s: the process's start to the first timed unit, on the host's
clock: imports, the kernels' libraries loaded (built on a checkout's
first run), the data made from the seed, the warm-up unit."""


def read(run):
    return run.setup_s
