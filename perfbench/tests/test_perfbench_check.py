"""The check that decides `correct`, on the CPU at a tiny size: the
plain reference itself, the control (the reference one precision step
down, in the program's place) failing the cell's limits, and a run of
the harness with the timed path broken underneath reading `correct`
false for each fault the cells can have (a solve that returns its state
unchanged, half of the rows left out, an answer altered where it is
produced; the cells run on one chip, so none has an exchange between
chips to leave out)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from perfbench_tiny import run_cell, tiny  # noqa: F401

from perfbench.core import registry
from perfbench.core.generate import make_data, mnist_like
from perfbench.reference import check, svm

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.14159265, 0.0], dtype=torch.float32)
    r = svm.to_tf32(x)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    assert r[1] == x[1] and r[2] == 1.0 + 2 ** -10 and r[3] == 1.0
    assert abs(float(r[4]) + 3.14159265) < 2 ** -9


def test_reference_solve_meets_its_stop_and_the_judge_agrees():
    X, Y = mnist_like(n=400, d=784, noise=30.0, label_noise=0.005, seed=9)
    Xf = torch.as_tensor(svm.minmax_scale(X, X).astype(np.float32))
    kw = dict(C=10.0, gamma=0.00125, eps=1e-12)
    r = svm.solve(Xf, Y, tau=1e-5, q=64, max_inner=4096, max_iter=100000,
                  **kw)
    assert r["status"] == "CONVERGED" and r["updates"] > 0
    j = svm.judge(Xf, Y, r["alpha"], **kw)
    assert j["gap"] <= 2e-5 * (1 + 1e-6)
    assert abs(j["b"] - r["b"]) < 1e-9
    assert j["box"] < 1e-12 and j["balance"] < 1e-9


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limits(tiny, cell):
    from perfbench import control

    root, bench = tiny
    w = registry.cell(bench, cell)
    cfg = registry.load_json("configs", w["config"], [root])
    traffic = registry.load_json("traffic", w["traffic"])
    limits = registry.load_json("limits", cell)
    entry = registry.load_module("entries", traffic["entry"])
    for seed in (5, 6, 7):
        data = make_data(cfg, seed)
        data["seed"] = seed
        prob = check.problem(cfg, data, "cpu")
        ans = control.control_answers(cfg, traffic, data, entry, prob, seed)
        numbers = check.compare(cfg, traffic, data, [ans], seed, "cpu",
                                prob=prob)
        assert any(numbers[k] > limits[k] for k in limits), numbers


def _unchanged(res):
    return dataclasses.replace(res, alpha=torch.zeros_like(res.alpha))


def _shift_b(res):
    return dataclasses.replace(res, b=res.b + 0.05)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_rows",
                                   "answer_altered"])
def test_broken_path_reads_not_correct(tiny, monkeypatch, cell, fault):
    import tpusvm_torch.models.svm as svm_model

    real_solo = svm_model.blocked_smo_solve

    def solo(X, Y, *a, **kw):
        if fault == "half_the_rows":
            kw["valid"] = torch.arange(len(Y)) < len(Y) // 2
        res = real_solo(X, Y, *a, **kw)
        return (_unchanged(res) if fault == "state_unchanged"
                else _shift_b(res) if fault == "answer_altered" else res)

    monkeypatch.setattr(svm_model, "blocked_smo_solve", solo)
    root, bench = tiny
    rc, res, err = run_cell(root, bench, cell, seed=41)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]
