"""Warm against cold coalesced tenant refreshes on the CPU, in both
packages, at the JAX tenants tests' shapes.

The corpus of tests/test_tenants.py and tests/test_torch_tenants.py (four
labelled blobs, 160 rows grown by 96 shifted ones, d=4), five tenants that
share one fleet launch and one that refreshes solo, donors provisioned on
the first 160 rows, then refresh_drifted over all 256 rows warm (seeded
by the donors) and cold, at q=16 and q=32 with max_inner=8. Prints, per
package and arm, the updates (n_iter) of the five coalesced lanes and of
all six tenants, each tenant's count, and whether the port's SV-ID sets
equal the JAX package's. Runs the JAX package on the CPU beside the port;
takes about 40 s.

  JAX_PLATFORMS=cpu python scripts/tenant_warm_counts.py
"""

import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

K, D, N0, GROW = 4, 4, 160, 96
C_PAL, G_PAL = (1.0, 3.0, 10.0), (0.5, 1.5, 5.0)


def corpus():
    rng = np.random.default_rng(1807)
    labels = rng.integers(0, K, size=N0 + GROW).astype(np.int32)
    means = rng.normal(0.0, 2.5, size=(K, D))
    X = means[labels] + rng.normal(0.0, 1.0, size=(N0 + GROW, D))
    X[N0:] += 0.6
    return X, labels


def records(cls):
    recs = [cls(tenant_id=f"t{i}", positive_label=i % K, C=C_PAL[i % 3],
                gamma=G_PAL[i % 3], row_mod=2 if i == 4 else None,
                row_ofs=1 if i == 4 else 0) for i in range(5)]
    return recs + [cls(tenant_id="t5", positive_label=1, C=3.0, gamma=1.5)]


def run(pkg, q, X, labels, td):
    opts = {"q": q, "max_inner": 8}
    if pkg == "torch":
        from tpusvm_torch.config import SVMConfig
        from tpusvm_torch.models import BinarySVC
        from tpusvm_torch.tenants import (TenantRecord, provision_tenants,
                                          refresh_drifted)
        dev = {"device": "cpu"}
    else:
        from tpusvm.config import SVMConfig
        from tpusvm.models import BinarySVC
        from tpusvm.tenants import (TenantRecord, provision_tenants,
                                    refresh_drifted)
        dev = {}
    donors = os.path.join(td, pkg, "donors")
    os.makedirs(donors)
    recs = records(TenantRecord)
    provision_tenants(X[:N0], labels[:N0], recs[:5], artifacts_dir=donors,
                      solver_opts=opts, **dev)
    # the odd tenant: another static template, so it refreshes solo
    provision_tenants(X[:N0], labels[:N0], recs[5:], artifacts_dir=donors,
                      config=SVMConfig(eps=1e-11), solver_opts=opts, **dev)
    out = {}
    for warm in (True, False):
        recs = records(TenantRecord)
        for r in recs:
            r.model_path = os.path.join(donors, r.tenant_id + ".npz")
        adir = os.path.join(td, pkg, "warm" if warm else "cold")
        res = refresh_drifted(X, labels, recs, artifacts_dir=adir, warm=warm,
                              solver_opts=opts, **dev)
        svs = {}
        for t in res:
            path = os.path.join(adir, t + ".npz")
            m = BinarySVC.load(path, **dev)
            svs[t] = tuple(np.asarray(m.sv_ids_).tolist())
        out[warm] = (res, svs)
    return out


def main() -> int:
    torch.set_num_threads(1)
    X, labels = corpus()
    for q in (16, 32):
        with tempfile.TemporaryDirectory() as td:
            got = {pkg: run(pkg, q, X, labels, td) for pkg in ("torch", "jax")}
        for pkg in ("torch", "jax"):
            for warm in (True, False):
                res, _ = got[pkg][warm]
                lanes = sum(int(o["n_iter"]) for o in res.values()
                            if o["mode"] == "fleet")
                every = sum(int(o["n_iter"]) for o in res.values())
                each = {t: int(o["n_iter"]) for t, o in sorted(res.items())}
                status = {str(getattr(o["status"], "name", o["status"]))
                          for o in res.values()}
                print(f"q={q} {pkg:5s} {'warm' if warm else 'cold'}: "
                      f"updates of the 5 coalesced lanes {lanes}, of all 6 "
                      f"tenants {every}; {each}; statuses {sorted(status)}")
        for warm in (True, False):
            same = got["torch"][warm][1] == got["jax"][warm][1]
            print(f"q={q} {'warm' if warm else 'cold'}: the port's SV-ID "
                  f"sets equal the JAX package's: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
