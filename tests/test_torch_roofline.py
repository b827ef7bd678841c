"""The port's roofline (``repro_torch.benchmarks.roofline``) against the
reference's ``benchmarks/roofline.py``, and ``run roofline`` over the
port's own dry-run records.

The reference's records come from its own ``dryrun_one`` on 512 forced
host devices, in one subprocess for the module
(``tests/torch_dryrun_ref.py``, part ``roofline``), started before the
port's side.

Bars: ``analytic_flops`` bitwise the reference's for every arch x shape x
aggregator on both meshes; ``load_rows`` under the reference's v5e
constants, on the reference's own records, the reference's rows exactly;
under the H100's constants, the three terms of each row from the record's
own fields.
"""
import contextlib
import io
import json
import os
import sys

import pytest

import torch_dryrun_ref as R
from repro_torch.benchmarks import roofline
from repro_torch.benchmarks import run as trun
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

#: the row fields the roofline derives from a record
ROW_KEYS = ("tag", "flops_analytic", "model_flops", "ota_flops", "t_compute",
            "t_memory", "t_collective", "dominant", "useful_ratio")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference, started before the module's first test."""
    ref = R.Reference(tmp_path_factory.mktemp("roofline_ref"), "roofline")
    yield ref
    ref.close()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(ref):
    yield


@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    """The port's dry-run records of smollm-360m's two decode shapes and
    one skip, as ``python -m repro_torch.launch.dryrun`` writes them."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    argv = ["--arch", "smollm_360m", "--shape", "decode_32k", "--out",
            str(out)]
    assert dryrun.main(argv) == 0
    assert dryrun.main(["--arch", "smollm_360m", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "whisper_base", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    return out


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_analytic_flops_bitwise_reference(ref, arch_id):
    for shape_id, shape in INPUT_SHAPES.items():
        for agg in R.AGGREGATORS:
            for n in (256, 512):
                got = roofline.analytic_flops(arch_id, shape_id, shape.kind,
                                              agg, n_chips=n)
                want = ref["analytic_flops"][f"{arch_id}/{shape_id}/{agg}/{n}"]
                assert got == want, (shape_id, agg, n)


def test_load_rows_under_v5e_constants_equal_reference(ref):
    rows = roofline.load_rows(results=ref.records_dir, **R.V5E)
    want = ref["rows"]
    assert len(rows) == len(want) == len(R.ROOFLINE_CASES)
    for got, w in zip(rows, want):
        assert {k: got[k] for k in ROW_KEYS} == {k: w[k] for k in ROW_KEYS}


def test_load_rows_on_h100_peaks_read_each_record(port_records):
    rows = roofline.load_rows(results=str(port_records))
    skipped = [r for r in rows if "skipped" in r]
    assert [r["tag"] for r in skipped] == [
        "whisper_base__long_500k__sp__a_dsgd__baseline"]
    counted = [r for r in rows if "skipped" not in r]
    assert [r["shape"] for r in counted] == ["decode_32k", "long_500k"]
    for r in counted:
        af = roofline.analytic_flops(r["arch"], r["shape"], r["kind"], None,
                                     n_chips=r["n_chips"])
        assert r["t_compute"] == af["total"] / (256 * PEAK_FLOPS_BF16)
        assert r["t_memory"] == r["bytes_accessed"] / HBM_BW
        assert r["t_collective"] == r["collective_bytes"]["total"] / LINK_BW
        terms = {k: r[f"t_{k}"] for k in ("compute", "memory", "collective")}
        assert r["dominant"] == max(terms, key=terms.get)
        assert r["advice"] == roofline.dominant_advice(r["dominant"], r)


def test_dominant_advice_has_three_branches():
    info = {"kernels": {"amp_fused": {"ops": 3.0}},
            "thread_mesh": {"flops": 4.0}}
    advice = {d: roofline.dominant_advice(d, info)
              for d in ("compute", "memory", "collective")}
    assert len(set(advice.values())) == 3
    assert advice["compute"].startswith("amp_fused is 75% of the counted")
    assert "psum" in advice["collective"]
    assert "HBM" in advice["memory"]
    assert not roofline.dominant_advice("compute", {}).startswith("amp")


def test_run_roofline_prints_the_reference_csv(port_records, monkeypatch):
    monkeypatch.setattr(roofline, "RESULTS", str(port_records))
    monkeypatch.setattr(sys, "argv", ["run", "roofline"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trun.main(device="cpu")
    lines = buf.getvalue().splitlines()
    hdr = lines.index("arch,shape,mesh,variant,aggregator,t_compute_s,"
                      "t_memory_s,t_collective_s,dominant,"
                      "model/total_flops,temp_GiB_per_dev")
    body = lines[hdr + 1:hdr + 4]
    assert body[0].startswith("smollm_360m,decode_32k,16x16,baseline,None,")
    assert body[1].startswith("smollm_360m,long_500k,16x16,baseline,None,")
    assert body[2].startswith("whisper_base__long_500k__sp__a_dsgd__baseline"
                              ",SKIPPED(")
    # the summary: one line a counted row (a skip has none)
    assert lines[-2:] == [
        "roofline_smollm_360m__decode_32k__sp__a_dsgd__baseline,0.0,memory",
        "roofline_smollm_360m__long_500k__sp__a_dsgd__baseline,0.0,memory"]
    table = os.path.join(str(port_records), "..",
                         "roofline_table_torch.json")
    with open(table) as f:
        assert len(json.load(f)) == 3
