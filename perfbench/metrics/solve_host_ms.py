"""solve_host_ms: host milliseconds of a fit's solve phase that were not
spent blocked at the solver's host synchronisations
(fit_phases_["solve"] - result_.host_wait_s): the outer loop's Python,
its launches and its selection, mean per fit."""


def read(run):
    vals = [u["phases"]["solve"] - u["counters"]["host_wait_s"]
            for u in run.units if "solve" in u["phases"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
