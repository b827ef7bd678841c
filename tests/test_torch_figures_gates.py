"""The port's gated figures (``repro_torch.benchmarks.fig9``-``fig13``)
against the reference's scripts on the CPU, at the tiny scale of
``tests/torch_bench_cases.py``: the CSV rows, the gate lines and the
summaries equal, a gate that raises ``SystemExit`` raising in both with the
same message, and the accuracies each writes to its JSON file equal.  Every
JSON file goes to ``tmp_path``.
"""
import importlib
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tests.torch_bench_cases import (  # noqa: E402,F401
    SPEC, comparable, csv_rows, one_torch_thread, run_main, tiny,
)

FIGURES = ("fig9_fading", "fig10_scaling", "fig11_robust", "fig12_local",
           "fig13_geometry")
#: where each figure's JSON goes: fig10 takes ``out_path`` in both
#: packages, the reference's fig12 and fig13 write to their ``OUT_PATH``
WRITES = ("fig10_scaling", "fig12_local", "fig13_geometry")


def _accuracies(path):
    if not path.exists():
        return None
    doc = json.loads(path.read_text())
    return {k: v for k, v in doc.items() if "acc" in k}


@pytest.mark.parametrize("name", FIGURES)
def test_gated_figure_equals_reference(tiny, monkeypatch, tmp_path, name):
    jmod = importlib.import_module(f"benchmarks.{name}")
    tmod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    jpath, tpath = tmp_path / "ref.json", tmp_path / "port.json"
    jkw, tkw = {}, {"device": "cpu"}
    if name == "fig10_scaling":
        for mod in (jmod, tmod):
            monkeypatch.setattr(mod, "spec", lambda: dict(SPEC))
        jkw["out_path"] = str(jpath)
    elif name in WRITES:
        monkeypatch.setattr(jmod, "OUT_PATH", str(jpath))
    if name in WRITES:
        tkw["out_path"] = str(tpath)
    jl, jexit, jsum = run_main(jmod.main, **jkw)
    tl, texit, tsum = run_main(tmod.main, **tkw)
    assert texit == jexit
    assert csv_rows(tl) and csv_rows(tl) == csv_rows(jl)
    assert comparable(tl) == comparable(jl)
    assert [(n, a) for n, _, a in tsum] == [(n, a) for n, _, a in jsum]
    if name in WRITES:
        assert _accuracies(tpath) == _accuracies(jpath)
        if jpath.exists():
            assert json.loads(tpath.read_text())["device"] == "cpu"
