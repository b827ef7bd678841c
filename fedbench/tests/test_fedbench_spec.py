"""BENCHMARK.json and the harness's files: present, well formed, and
consistent with each other; and the harness imports no JAX."""
import ast
import json
import re
import subprocess
import sys

import pytest

from fedbench.tests import tiny

REPO = tiny.REPO
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "fedbench/run.py"]
    assert SPEC["paths"] == ["fedbench"]
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_allowed(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metric_entries(group):
    keys = {"end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[group]
    for m in SPEC[group]:
        assert set(m) - {"workloads"} == keys, m["name"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(CELLS)
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_setup_s_and_another_end_to_end_metric_in_every_cell():
    for cell in CELLS:
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if cell in m.get("workloads", [cell])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in SPEC["per_layer"])


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    for m in SPEC["per_layer"]:
        moved = {e["name"]: e for e in SPEC["end_to_end"]}[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    src = (REPO / "fedbench" / "metrics" / f"{metric}.py").read_text()
    assert "def read(" in src


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert entry["file"].startswith("fedbench/configs/")
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    # no width is ever cut
    widths = ("hidden_size", "intermediate_size", "num_attention_heads",
              "num_key_value_heads", "num_experts_per_tok", "head_dim")
    assert not set(entry["reduced"]) & set(widths)
    assert not any(k.endswith(("_dim", "_rank")) for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_files(entry):
    wl = json.loads((REPO / "fedbench" / "workloads"
                     / f"{entry['name']}.json").read_text())
    for k in ("name", "config", "traffic", "chips", "why"):
        assert wl[k] == entry[k], k
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert NAME.match(entry["traffic"]) and NAME.match(entry["config"])
    assert (REPO / "fedbench" / "drivers" / f"{wl['driver']}.py").is_file()
    assert set(wl["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert all(v > 0 for v in wl["limits"].values())


def test_file_names_under_paths_are_made_of_name_characters():
    for path in (REPO / "fedbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(REPO).as_posix()
        assert all(NAME.match(part) for part in rel.split("/")), rel


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((REPO / "fedbench").rglob("*.py")),
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    names = set(_top_level_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "fedbench" / "reference").glob("*.py"):
        assert "repro_torch" not in set(_top_level_imports(path)), path


def test_a_dropped_workload_file_is_found(tmp_path):
    """A cell added as files to a copy is found by name: the run gets as
    far as looking for a card."""
    root = tiny.make_copy(tmp_path)
    out = subprocess.run(
        [sys.executable, "fedbench/run.py", "--workload",
         "tiny_dense.adsgd_round", "--seed", "3", "--seconds", "1"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr
    missing = subprocess.run(
        [sys.executable, "fedbench/run.py", "--workload", "no_such.cell",
         "--seed", "3", "--seconds", "1"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert missing.returncode != 0 and "no cell" in missing.stderr


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_settings_are_the_ports_defaults_for_the_model(entry):
    """The frozen scheme is ``ota_overrides(arch)`` with the kernels on, and
    the optimizer ``TrainConfig()``, as the port's streamed round runs a
    zoo model."""
    import dataclasses

    from repro_torch.configs.base import (OTAConfig, TrainConfig,
                                          ota_overrides)

    wl = json.loads((REPO / "fedbench" / "workloads"
                     / f"{entry['name']}.json").read_text())
    want = dataclasses.replace(ota_overrides(entry["config"]),
                               use_kernel=True)
    assert OTAConfig(**wl["ota"]) == want
    assert TrainConfig(**wl["train"]) == TrainConfig()
