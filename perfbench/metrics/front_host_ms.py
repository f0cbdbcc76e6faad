"""front_host_ms: host milliseconds a fit spends in the estimator's front
(scale, cast, to_device, to_host, sv_extract of BinarySVC.fit_phases_),
mean per fit. Nothing to read where the program reports no phases."""

PHASES = ("scale", "cast", "to_device", "to_host", "sv_extract")


def read(run):
    vals = [sum(u["phases"][p] for p in PHASES) for u in run.units
            if all(p in u["phases"] for p in PHASES)]
    return 1e3 * sum(vals) / len(vals) if vals else None
