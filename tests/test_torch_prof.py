"""The port's compile observatory (tpusvm_torch.obs.prof / obs.costs) held
to the JAX package's tpusvm.obs.prof / obs.costs on the CPU.

  * costs: the same summaries, intensities and unavailable markers as
    tests/test_prof.py asserts of the JAX module, from the same fake
    compiled objects; compile_record gives the same dict;
  * records: one prof.compile event and the same gauges and counter in the
    registry per record, through either package's record_compile;
  * the port's build sites: one record per (model, bucket) program serve
    builds, one per library an nvcc build commits (a stand-in compiler on
    the CPU), each with cost_available False;
  * bit-transparency: a fit and a served score with the observatory on are
    the bits with it off.
"""

import os
import stat
import sys

import numpy as np
import pytest

from tpusvm.obs import costs as jcosts
from tpusvm.obs import prof as jprof
from tpusvm.obs.registry import MetricsRegistry as JRegistry
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data import rings
from tpusvm_torch.models import BinarySVC
from tpusvm_torch.obs import costs, prof
from tpusvm_torch.obs.registry import MetricsRegistry


@pytest.fixture(autouse=True)
def _profiling_off():
    yield
    prof.disable_profiling()
    jprof.disable_profiling()


class _FakeCompiled:
    def __init__(self, cost, mem=None):
        self._cost, self._mem = cost, mem

    def cost_analysis(self):
        if isinstance(self._cost, Exception):
            raise self._cost
        return self._cost

    def memory_analysis(self):
        return self._mem


class _Mem:
    argument_size_in_bytes = 10
    output_size_in_bytes = 20
    temp_size_in_bytes = 30
    generated_code_size_in_bytes = 40


COSTS = [{"flops": 10.0, "bytes accessed": 5.0},
         [{"flops": 4.0, "bytes accessed": 2.0}, {"flops": 6.0}],
         None, [], RuntimeError("no cost model"), {"utilization": 1.0}]


@pytest.mark.parametrize("cost", COSTS, ids=range(len(COSTS)))
def test_cost_summary_matches(cost):
    assert costs.cost_summary(_FakeCompiled(cost)) == \
        jcosts.cost_summary(_FakeCompiled(cost))


def test_cost_summary_shapes():
    # tests/test_prof.py's assertions, on the port's module
    d = {"flops": 10.0, "bytes accessed": 5.0}
    assert costs.cost_summary(_FakeCompiled(d)) == {
        "available": True, "flops": 10.0, "bytes_accessed": 5.0}
    lst = [{"flops": 4.0, "bytes accessed": 2.0}, {"flops": 6.0}]
    s = costs.cost_summary(_FakeCompiled(lst))
    assert s["flops"] == 10.0 and s["bytes_accessed"] == 2.0
    for bad in (None, [], RuntimeError("no cost model")):
        assert costs.cost_summary(_FakeCompiled(bad)) == {
            "available": False, "flops": None, "bytes_accessed": None}


@pytest.mark.parametrize("mem", [None, _Mem()], ids=["absent", "present"])
def test_memory_summary_matches(mem):
    assert costs.memory_summary(_FakeCompiled(None, mem)) == \
        jcosts.memory_summary(_FakeCompiled(None, mem))


@pytest.mark.parametrize("flops,nbytes", [(10.0, 5.0), (None, 5.0),
                                          (10.0, None), (10.0, 0.0)])
def test_arithmetic_intensity_edges(flops, nbytes):
    assert costs.arithmetic_intensity(flops, nbytes) == \
        jcosts.arithmetic_intensity(flops, nbytes)


@pytest.mark.parametrize("compiled", [None, _FakeCompiled(None),
                                      _FakeCompiled(COSTS[0], _Mem())],
                         ids=["none", "unavailable", "priced"])
def test_compile_record_matches(compiled):
    want = jcosts.compile_record("x", 0.1, 0.2, compiled, bucket=4)
    got = costs.compile_record("x", 0.1, 0.2, compiled, bucket=4)
    assert got == want
    if compiled is None or compiled._cost is None:
        # the contract: unknown cost is said, never zeros
        assert got["cost_available"] is False and got["flops"] is None


def _gauges(reg):
    return {(e["name"], tuple(sorted(e["labels"].items()))): e.get("value")
            for e in reg.snapshot()["metrics"]}


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_record_compile_matches_the_jax_observatory(on):
    jreg, treg = JRegistry(), MetricsRegistry()
    jev, tev = [], []
    if on:
        jprof.enable_profiling(registry=jreg,
                               event_sink=lambda n, **a: jev.append((n, a)))
        prof.enable_profiling(registry=treg,
                              event_sink=lambda n, **a: tev.append((n, a)))
    for name, lower, comp in (("serve.bucket[m:b4]", 0.01, 0.2),
                              ("serve.bucket[m:b4]", 0.02, 0.1),
                              ("nvcc:pair_rows", 0.0, 5.5)):
        jr = jprof.record_compile(name, lower, comp, registry=jreg, kind="k")
        tr = prof.record_compile(name, lower, comp, registry=treg, kind="k")
        assert tr == jr
    assert _gauges(treg) == _gauges(jreg)
    assert _gauges(treg)[("prof.compiles",
                          (("executable", "serve.bucket[m:b4]"),))] == 2
    assert tev == jev and len(tev) == (3 if on else 0)
    if on:
        assert [r["executable"] for r in prof.current().records] == [
            "serve.bucket[m:b4]", "serve.bucket[m:b4]", "nvcc:pair_rows"]


def test_profiling_context_restores_the_default():
    assert not prof.profiling_enabled() and prof.current() is None
    with prof.profiling(registry=MetricsRegistry()) as obs:
        assert prof.current() is obs and prof.profiling_enabled()
    assert prof.current() is None


def test_serve_bucket_builds_are_records_and_change_no_bit():
    from tpusvm_torch.serve.buckets import CompileCache
    from tpusvm_torch.serve.registry import ModelEntry

    X, Y = rings(n=120, seed=4)
    model = BinarySVC(SVMConfig(C=10.0, gamma=10.0), device="cpu").fit(X, Y)
    entry = ModelEntry.from_estimator("m", model, device="cpu")
    Xq = model.scaler_.transform(X[:20])
    plain = CompileCache(entry, (8, 32), registry=MetricsRegistry())
    plain.warmup()
    events = []
    reg = MetricsRegistry()
    with prof.profiling(registry=reg,
                        event_sink=lambda n, **a: events.append((n, a))):
        cache = CompileCache(entry, (8, 32), registry=reg)
        assert cache.warmup() == 2
        got, _ = cache.scores(Xq)
    want, _ = plain.scores(Xq)
    assert got.tobytes() == want.tobytes()
    assert [a["executable"] for _, a in events] == [
        "serve.bucket[m:b8]", "serve.bucket[m:b32]"]
    assert all(n == "prof.compile" and a["cost_available"] is False
               and a["model"] == "m" and a["kind"] == "binary"
               for n, a in events)
    assert _gauges(reg)[("prof.compiles",
                         (("executable", "serve.bucket[m:b8]"),))] == 1


def test_a_profiled_fit_is_the_unprofiled_fit():
    X, Y = rings(n=200, seed=5)
    cfg = SVMConfig(C=10.0, gamma=10.0)
    base = BinarySVC(cfg, device="cpu", solver="pair").fit(X, Y)
    with prof.profiling(registry=MetricsRegistry()):
        on = BinarySVC(cfg, device="cpu", solver="pair").fit(X, Y)
    assert on.sv_alpha_.tobytes() == base.sv_alpha_.tobytes()
    assert np.array_equal(on.sv_ids_, base.sv_ids_) and on.b_ == base.b_


def test_an_nvcc_build_commits_durably_and_is_one_record(tmp_path,
                                                         monkeypatch):
    from tpusvm_torch.ops.cuda import _build

    # a stand-in compiler: writes the -o file, prints a resource line
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'lib')\n"
        "print('ptxas info: 32 registers')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    build = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "_lib_path",
                        lambda name: build / f"lib{name}-0.so")
    events = []
    with prof.profiling(registry=MetricsRegistry(),
                        event_sink=lambda n, **a: events.append(a)):
        secs = _build.build_all(["pair_rows", "inner_smo"])
    assert sorted(os.listdir(build)) == [
        "inner_smo.log", "libinner_smo-0.so", "libpair_rows-0.so",
        "pair_rows.log"]
    assert [e["executable"] for e in events] == ["nvcc:pair_rows",
                                                 "nvcc:inner_smo"]
    for e in events:
        name = e["executable"].split(":")[1]
        assert e["compile_s"] == secs[name] > 0
        assert e["lower_s"] == 0.0 and e["cost_available"] is False
        assert e["kind"] == "nvcc" and e["source"] == name + ".cu"
    # built libraries are not rebuilt, and a cached build is no record
    events.clear()
    with prof.profiling(registry=MetricsRegistry(),
                        event_sink=lambda n, **a: events.append(a)):
        assert _build.build_all(["pair_rows"]) == {"pair_rows": 0.0}
    assert events == []
