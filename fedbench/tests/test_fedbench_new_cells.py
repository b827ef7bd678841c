"""The cells added as files for the sharded trainer's step and the
granite-4.0-h hybrid round: the files parse and agree, and tiny versions
of both run on the CPU past the look for a card, on a copy made as
:mod:`fedbench.tests.tiny` makes one.  A sound run comes out correct
under the cells' own limits, and a planted fault does not: half of each
device's batch left out, and a step that leaves the parameters unchanged."""
import json

import pytest

from fedbench.tests import tiny

REPO = tiny.REPO
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NEW = {"smollm_360m.train_step": ("train_step", ("train_phase1_ms",)),
       "granite_4_0_h_micro.adsgd_round": ("fedllm_hybrid_round",
                                           ("mamba_ms", "hybrid_round_mfu",
                                            "hybrid_grads_ms"))}

#: a tiny hybrid in the published keys: two periods of (Mamba2, attention,
#: Mamba2), two groups of B and C, chunks of 8 over 20 tokens
TINY_HYBRID = dict(
    name="tiny_hybrid", source="a test's size",
    hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
    shared_intermediate_size=96, intermediate_size=96, vocab_size=256,
    num_hidden_layers=6, layer_types=["mamba", "attention", "mamba"] * 2,
    rms_norm_eps=1e-5, mamba_n_heads=8, mamba_d_head=16, mamba_d_state=8,
    mamba_n_groups=2, mamba_d_conv=4, mamba_expand=2, mamba_chunk_size=8,
    embedding_multiplier=12, attention_multiplier=0.015625,
    residual_multiplier=0.22, logits_scaling=8,
    position_embedding_type="nope", rope_theta=10000,
    tie_word_embeddings=True, reduced=[])
TINY_CELLS = {
    "tiny_hybrid.adsgd_round": ("granite_4_0_h_micro.adsgd_round",
                                "tiny_hybrid"),
    "tiny_dense.train_step": ("smollm_360m.train_step", "tiny_dense")}


def test_new_files_parse_and_agree():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    for name, (driver, metrics) in NEW.items():
        wl = json.loads((REPO / "fedbench" / "workloads"
                         / f"{name}.json").read_text())
        assert wl["driver"] == driver and cells[name]["chips"] == 1
        assert (REPO / "fedbench" / "drivers" / f"{driver}.py").is_file()
        for metric in metrics:
            listed = {m["name"]: m for m in SPEC["per_layer"]}[metric]
            assert listed["workloads"] == [name]
            assert (REPO / "fedbench" / "metrics" / f"{metric}.py").is_file()
    cfg = json.loads((REPO / "fedbench" / "configs"
                      / "granite_4_0_h_micro.json").read_text())
    assert cfg["reduced"] == ["num_hidden_layers", "layer_types"]
    assert cfg["layer_types"] == cfg["source_values"]["layer_types"][:10]
    assert cfg["num_hidden_layers"] == 10
    assert (REPO / cfg["reference"]).is_file()


def test_hybrid_cost_counts_the_period():
    from fedbench.cost import hybrid_round

    cfg = json.loads((REPO / "fedbench" / "configs"
                      / "granite_4_0_h_micro.json").read_text())
    flops = hybrid_round.forward_flops(cfg, 2, 1024)
    # the matrix products alone at 2 x 1024 tokens: 9 Mamba2 layers'
    # projections, 1 attention layer's, 10 MLPs, the head
    d, t = 2048, 2048
    mats = t * 2 * (9 * d * (8512 + 4096) + d * 5120 + 10 * 3 * d * 8192
                    + d * 100352 * 1023 / 1024)
    assert mats < flops < 1.2 * mats


def make_copy(dest):
    """``tiny.make_copy``'s copy, with the two new cells' tiny versions
    added as files and entries."""
    root = tiny.make_copy(dest)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (root / "fedbench" / "configs" / "tiny_hybrid.json").write_text(
        json.dumps(TINY_HYBRID))
    spec["configs"].append({"name": "tiny_hybrid", "source": "a test's size",
                            "file": "fedbench/configs/tiny_hybrid.json",
                            "reduced": [], "why": "a CPU test"})
    expect = {"tiny_hybrid.adsgd_round": {"d": 264736, "n_chunks": 65,
                                          "chunk_len": 4096},
              "tiny_dense.train_step": {"d": 90432, "d_pad": 90624,
                                        "m_devices": 4}}
    for cell, (template, config) in TINY_CELLS.items():
        wl = json.loads((REPO / "fedbench" / "workloads"
                         / f"{template}.json").read_text())
        wl.update(name=cell, config=config)
        wl["ota"]["block_size"] = 256
        wl["round"]["expect"] = expect[cell]
        if "mesh" in wl["round"]:
            wl["round"].update(batch=8, seq_len=16)
        else:
            wl["round"].update(chunk_len=4096, seq_len=20)
        (root / "fedbench" / "workloads" / f"{cell}.json").write_text(
            json.dumps(wl))
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": wl["traffic"], "chips": 1,
                                  "why": "a CPU test"})
        for m in spec["per_layer"]:
            if template in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


CODE = r'''
import dataclasses, json, time
from fedbench import bench


class Frozen:
    """A step that returns its parameters unchanged."""
    def __init__(self, opt):
        self.init = opt.init

    def apply(self, params, grads, state):
        return params, state


def frozen(c):
    if hasattr(c, "fed"):
        c.fed.opt = Frozen(c.fed.opt)
    else:
        c.ts.train = dataclasses.replace(c.ts.train, lr=0.0)


def half_batch(c):
    if hasattr(c, "fed"):
        draw = c.fed._device_batch

        def broken(key):
            b = draw(key)
            b["tokens"] = b["tokens"][: b["tokens"].shape[0] // 2]
            return b
        c.fed._device_batch = broken
    else:
        draw = c.batch

        def broken(key):
            tok = draw(key)["tokens"]
            m = c.ts.m_devices
            per = tok.shape[0] // m
            keep = [tok[i * per:i * per + per // 2] for i in range(m)]
            import torch
            return {"tokens": torch.cat(keep)}
        c.batch = broken


PLANTS = {"sound": None, "frozen": frozen, "half_batch": half_batch}
out = {}
for case in CASES:
    r = bench.run(CELL, 2**31 + 101, 0.5, False, time.perf_counter(),
                  device="cpu", plant=PLANTS[case])
    out[case] = {"correct": r["correct"], "checks": r["checks"],
                 "metrics": sorted(r["metrics"])}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("fedbench_new"))


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_sound_run_is_correct_and_each_fault_is_not(root, cell):
    cases = ["sound", "frozen", "half_batch"]
    out = tiny.run_python(root, f"CELL = {cell!r}\nCASES = {cases!r}\n"
                          + CODE, timeout=900)
    assert out["sound"]["correct"], out["sound"]
    assert {"round_ms", "setup_s"} <= set(out["sound"]["metrics"])
    for case in cases[1:]:
        assert not out[case]["correct"], (case, out[case])
