"""outer_rounds: outer rounds of the single-problem blocked solver
(SMOResult.n_outer), mean per fit. Units that count lane_rounds (a
fleet's lockstep solve) are left out."""


def read(run):
    vals = [u["counters"]["rounds"] for u in run.units
            if "lane_rounds" not in u["counters"]]
    return sum(vals) / len(vals) if vals else None
