"""A copy of the harness with two tiny cells added as files, for the CPU
tests: the cells' own settings at a size a CPU runs in seconds."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELLS = {"tiny_dense": dict(intermediate_size=128),
         "tiny_moe": dict(intermediate_size=32, num_local_experts=8,
                          num_experts_per_tok=2)}
#: the tiny models' parameter counts, and chunks of 4096
EXPECT = {"tiny_dense": {"d": 90432, "n_chunks": 23, "chunk_len": 4096},
          "tiny_moe": {"d": 140608, "n_chunks": 35, "chunk_len": 4096}}


def tiny_config(name: str) -> dict:
    return dict(name=name, hidden_size=64, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16, vocab_size=256,
                num_hidden_layers=2, rms_norm_eps=1e-5, rope_theta=10000.0,
                tie_word_embeddings=True, **CELLS[name])


def make_copy(dest: Path, template: str = "smollm_360m.adsgd_round") -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``fedbench/`` with a cell
    ``<tiny>.adsgd_round`` for each tiny model, added as new files and
    entries only: each workload is ``template``'s, with the tiny model's
    chunks and 256-entry blocks."""
    shutil.copytree(REPO / "fedbench", dest / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in CELLS:
        cell = f"{name}.adsgd_round"
        (dest / "fedbench" / "configs" / f"{name}.json").write_text(
            json.dumps(tiny_config(name)))
        wl = json.loads((REPO / "fedbench" / "workloads"
                         / f"{template}.json").read_text())
        wl.update(name=cell, config=name)
        wl["round"].update(chunk_len=4096, expect=EXPECT[name])
        wl["ota"]["block_size"] = 256
        (dest / "fedbench" / "workloads" / f"{cell}.json").write_text(
            json.dumps(wl))
        spec["configs"].append({"name": name, "source": "a test's size",
                                "file": f"fedbench/configs/{name}.json",
                                "reduced": [], "why": "a CPU test"})
        spec["workloads"].append({"name": cell, "config": name,
                                  "traffic": "adsgd_round", "chips": 1,
                                  "why": "a CPU test"})
        for m in spec["per_layer"]:
            m.setdefault("workloads", []).append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


def run_python(root: Path, code: str, timeout: float = 600):
    """``code`` in a fresh interpreter that imports the copy's harness and
    the repository's port; its stdout's last line as JSON."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(REPO / "src")]), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
