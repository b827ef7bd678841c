"""The port's benchmark harness against the reference's, on the CPU:
``repro_torch.core.convergence`` function for function, ``common``'s data,
configs and rows, the Theorem 1 rows, ``bench_kernels`` at its smoke sizes
(kernel path equal to the plain path, its JSON read by the reference's
``check_regression`` with every entry matched), ``bench_sweeps`` at
``SMOKE`` size, the two examples and the registry of ``run``.

``common``'s pieces run on ``tests/test_bench_common.py``'s tiny data (4
devices of 32 samples, dim 24, noise 2.0); the rest at the tiny scale of
``tests/torch_bench_cases.py``.
"""
import contextlib
import dataclasses
import functools
import inspect
import io
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from repro.core import convergence as jcv
from repro_torch.benchmarks import (
    bench_kernels, bench_sweeps, convergence_bound, run as trun,
)
from repro_torch.core import convergence as tcv
from repro_torch.examples import paper_repro, quickstart

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import check_regression  # noqa: E402
from benchmarks import convergence_bound as jbound  # noqa: E402
from tests.torch_bench_cases import (  # noqa: E402,F401
    jcommon, jsyn, one_torch_thread, run_main, tcommon, tiny, tsyn,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = dict(device="cpu")

# ---------------------------------------------------------------------------
# core/convergence.py: the same Python, so the same floats
# ---------------------------------------------------------------------------

PUBLIC = ("lambda_val", "sigma_max", "chi2_quantile", "rho", "v_t",
          "sum_v_constant_power", "eta_max", "theorem1_bound")
_KW = dict(d=7850, k=1962, s_tilde=3923, m=25, sigma=1.0, g_bound=1.0)
CV_CASES = [
    ("lambda_val", (7850, 1962), {}), ("lambda_val", (100, 0), {}),
    ("sigma_max", (7850, 3923), {}),
    ("_gammainc_lower_reg", (0.5, 0.2), {}),
    ("_gammainc_lower_reg", (3925.0, 4000.0), {}),
    ("chi2_quantile", (1, 0.95), {}), ("chi2_quantile", (7850, 0.999), {}),
    ("rho", (1e-3, 7850), {}),
    ("v_t", (0,), dict(p_t=500.0, **_KW)),
    ("v_t", (250,), dict(p_t=1.0, delta_prob=1e-2, **_KW)),
    ("sum_v_constant_power", (10_000,), dict(p_avg=500.0, **_KW)),
    ("eta_max", (10_000, 1.0, 1.0, 1.0, 123.4), {}),
    ("theorem1_bound", (10_000,), dict(eta=0.1, c_strong=1.0, eps=1.0,
                                       g_bound=1.0, sum_v=50.0,
                                       theta_star_norm=10.0)),
    ("theorem1_bound", (10,), dict(eta=3.0, c_strong=1.0, eps=1.0,
                                   g_bound=1.0, sum_v=50.0,
                                   theta_star_norm=10.0)),
]


def test_convergence_is_the_reference_source():
    assert inspect.getsource(tcv) == inspect.getsource(jcv)
    for name in PUBLIC:
        assert callable(getattr(tcv, name))


@pytest.mark.parametrize("name,args,kw", CV_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CV_CASES)])
def test_convergence_equals_reference(name, args, kw):
    assert getattr(tcv, name)(*args, **kw) == getattr(jcv, name)(*args, **kw)


def test_convergence_bound_rows_equal_reference():
    jl, _, jsum = run_main(jbound.main)
    tl, _, tsum = run_main(convergence_bound.main, **CPU)
    assert tl == jl and len(tl) == 7
    assert tsum[0][0] == jsum[0][0] and tsum[0][2] == jsum[0][2]


# ---------------------------------------------------------------------------
# common.py on test_bench_common.py's tiny data
# ---------------------------------------------------------------------------


@pytest.fixture
def bench_common_data(monkeypatch):
    """Both ``common`` modules at test_bench_common.py's tiny data."""
    for common, syn in ((jcommon, jsyn), (tcommon, tsyn)):
        monkeypatch.setattr(common, "make_classification", functools.partial(
            syn.make_classification, dim=24))
        for field, value in dict(m=4, b=32, n_train=400, n_test=120,
                                 noise=2.0).items():
            monkeypatch.setattr(common.SCALE, field, value)


@pytest.mark.parametrize("kw", [dict(iid=True), dict(iid=False),
                                dict(partition="dirichlet", beta=0.5),
                                dict(m=2, b=50, seed=5)])
def test_dataset_equals_reference(bench_common_data, kw):
    (jxd, jyd), (jxt, jyt) = jcommon.dataset(**kw)
    (txd, tyd), (txt, tyt) = tcommon.dataset(**kw)
    for a, b in ((txd, jxd), (tyd, jyd), (txt, jxt), (tyt, jyt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("scheme,kw", [
    ("a_dsgd", {}), ("d_dsgd", dict(p_avg=200.0)), ("ideal", {}),
    ("signsgd", {}), ("qsgd", {}),
    ("a_dsgd_fading", dict(fading_threshold=0.3, ps_antennas=2)),
    ("a_dsgd", dict(total_steps=16, k_frac=0.8, s_frac=0.1))])
def test_ota_fields_equal_reference(scheme, kw):
    assert dataclasses.asdict(tcommon.ota(scheme, **kw)) == \
        dataclasses.asdict(jcommon.ota(scheme, **kw))


def test_ota_rejects_unknown_scheme():
    with pytest.raises(KeyError, match="unknown scheme"):
        tcommon.ota("not_a_scheme")


@pytest.mark.parametrize("axes,kw,steps", [
    ({"seed": [0, 1]}, dict(scheme="ideal"), 6),
    ({"scheme": ["ideal", "d_dsgd"]}, {}, 4),
    ({"p_avg": [50.0, 500.0]}, dict(scheme="a_dsgd"), 4)])
def test_sweep_series_rows_equal_reference(bench_common_data, axes, kw,
                                           steps):
    dev, test = jcommon.dataset()
    name = "-".join(axes)
    jrows, trows = [], []
    _, jsum = jcommon.sweep_series(
        "figX", dev, test, axes, lambda r: str(r[name]), rows=jrows,
        steps=steps, **kw)
    _, tsum = tcommon.sweep_series(
        "figX", dev, test, axes, lambda r: str(r[name]), rows=trows,
        steps=steps, **CPU, **kw)
    every = jcommon.SCALE.eval_every
    n_evals = len([t for t in range(steps)
                   if t % every == 0 or t == steps - 1])
    assert trows == jrows and len(trows) == len(axes[name]) * n_evals
    assert [(n, a) for n, _, a in tsum] == [(n, a) for n, _, a in jsum]


def test_run_series_rows_equal_reference(bench_common_data):
    dev, test = jcommon.dataset()
    kw = dict(total_steps=4)
    want = jcommon.run_series("figL", "a", dev, test,
                              jcommon.ota("a_dsgd", **kw), steps=4)
    got = tcommon.run_series("figL", "a", dev, test,
                             tcommon.ota("a_dsgd", **kw), steps=4, **CPU)
    assert got["rows"] == want["rows"] and got["us_per_call"] > 0
    assert got["final_acc"] == want["final_acc"]


def test_emit_prints_header_then_rows(capsys):
    tcommon.emit(["f,s,0,0.5000"])
    assert capsys.readouterr().out.splitlines() == [
        "figure,series,step,test_accuracy", "f,s,0,0.5000"]


def test_device_info_on_cpu():
    assert tcommon.device_info("cpu") == {"device": "cpu",
                                          "power_limit": None}


# ---------------------------------------------------------------------------
# bench_kernels and bench_sweeps
# ---------------------------------------------------------------------------


def test_bench_kernels_smoke_on_cpu(tmp_path):
    """Both paths at the smoke sizes, the kernel path (the plain version on
    a CPU tensor, no launch) equal to the plain path, and the JSON read by
    the reference's regression gate with every entry matched."""
    out = tmp_path / "BENCH_torch_kernels.json"
    doc = bench_kernels.main(out_path=str(out), **CPU)
    assert json.loads(out.read_text()) == doc
    assert doc["device"] == "cpu" and doc["interpret"] is False
    assert doc["smoke"] is True and doc["power_limit"] is None
    entries = doc["entries"]
    assert [(e["size"], e["op"], e["path"]) for e in entries] == [
        (size[0], op, path) for size in bench_kernels.SIZES_SMOKE
        for path in ("plain", "kernel") for op in bench_kernels.KERNEL_OF]
    for e in entries:
        assert e["us_per_call"] > 0
        if e["path"] == "kernel":
            assert e["max_abs_err"] == 0.0 and e["launches"] == 0
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        assert check_regression.compare(doc, doc, strict=True) == 0
    lines = log.getvalue().splitlines()
    assert sum(ln.strip().startswith("ok ") for ln in lines) == len(entries)
    assert not any("WARNING" in ln or "STRICT" in ln for ln in lines)


def test_bench_kernels_check_op_raises_on_a_miss():
    x = torch.ones(3)
    with pytest.raises(RuntimeError, match="off its plain path"):
        bench_kernels.check_op("proj_adj", lambda: x + 1e-7, lambda: x,
                               torch.device("cpu"))
    with pytest.raises(RuntimeError, match="off its plain path"):
        bench_kernels.check_op("amp_decode", lambda: x + 1e-3, lambda: x,
                               torch.device("cpu"))


def test_bench_sweeps_smoke_on_cpu(tiny, monkeypatch, tmp_path):
    monkeypatch.setattr(bench_sweeps, "SMOKE", True)
    out = tmp_path / "BENCH_torch_sweeps.json"
    res = bench_sweeps.main(out_path=str(out), **CPU)
    assert json.loads(out.read_text()) == res
    assert res["grid_points"] == 2 and res["rounds"] == 3
    assert res["max_final_acc_deviation"] == 0.0 and res["device"] == "cpu"
    for name in ("looped", "compiled_cold", "compiled_steady"):
        assert res[f"{name}_us_per_round"] > 0
    with contextlib.redirect_stdout(io.StringIO()):
        assert check_regression.compare(res, res, strict=True) == 0


# ---------------------------------------------------------------------------
# the examples and the registry
# ---------------------------------------------------------------------------


def test_quickstart_equals_reference(tiny, monkeypatch):
    monkeypatch.setattr(quickstart, "make_classification",
                        tsyn.make_classification)
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        runpy.run_path(os.path.join(ROOT, "examples", "quickstart.py"))
    got, _, _ = run_main(lambda collect: quickstart.main(**CPU))
    assert got == want.getvalue().splitlines() and len(got) == 3


def test_paper_repro_runs_the_named_benchmark(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["paper_repro", "thm1"])
    got, _, _ = run_main(lambda collect: paper_repro.main(**CPU))
    want, _, _ = run_main(jbound.main)
    assert got[got.index("figure,series,T,bound"):][:7] == want
    assert got[-2:][0] == "name,us_per_call,derived"
    assert got[-1].startswith("thm1_bound,")


def test_run_rejects_an_unknown_benchmark(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run", "fig99"])
    with pytest.raises(SystemExit, match="unknown benchmark"):
        trun.main(**CPU)


@pytest.mark.parametrize("name", ["bench_kernels", "bench_sweeps",
                                  "fig10_scaling", "fig12_local"])
def test_main_defaults_to_the_card(tmp_path, name):
    """``device=None`` is the card: without one a main raises before it
    writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import importlib
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    out = tmp_path / "out.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(out_path=str(out))
    assert not out.exists()
