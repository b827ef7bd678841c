"""The benchmark's plain reference of the sharded trainer's step
(``fedbench/reference/train_step.py``) against the port's flat-layout
``make_train_step`` on a 4 x 2 mesh of rank threads, at a tiny size: three
steps from one seed, their ``global_loss``, the first step's ĝ and each
parameter after the steps.

The reference draws the weights, the tokens, the projections and the
noise from the seed on its own, and sums every reduction the port sums in
a fixed order in that order (the threshold's quantile, the frame's sums in
XLA's CPU order, the MAC in device order, A's products in float64 rounded
once), so the two agree bit for bit on the CPU and on the card.  The
``cuda`` case skips without a card.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fedbench.reference import fedllm as ref  # noqa: E402
from fedbench.reference import train_step as ref_step  # noqa: E402
from fedbench.reference import transformer as tfm  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ArchConfig, OTAConfig, TrainConfig,
)
from repro_torch.convert import tree_leaves  # noqa: E402
from repro_torch.experiments.engine import round_keys  # noqa: E402
from repro_torch.sharding import Mesh  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402

SEED, STEPS, KEY_ROUNDS = 2**31 + 7, 3, 64
CONFIG = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
              head_dim=16, vocab_size=256, num_hidden_layers=2,
              intermediate_size=128, rms_norm_eps=1e-5, rope_theta=10000.0)
OTA = dict(scheme="a_dsgd", projection="blocked", block_size=256,
           s_frac=0.25, k_frac=0.5, rademacher=True, use_kernel=True,
           amp_iters=20, mean_removal_steps=20)
WORKLOAD = {"round": {"mesh": [4, 2], "batch": 8, "seq_len": 16,
                      "key_rounds": KEY_ROUNDS},
            "ota": dict(OTAConfig(**OTA).__dict__),
            "train": dict(TrainConfig().__dict__)}


def port_run(device):
    arch = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      head_dim=16, tie_embeddings=True)
    ts = make_train_step(arch, TrainConfig(),
                         dataclasses.replace(OTAConfig(**OTA),
                                             shard_decode=True),
                         Mesh((4, 2), ("data", "model")), ota_axes=("data",),
                         device=device)
    params, opt_state, delta = ts.init_state(rng.PRNGKey(SEED,
                                                         device=device))
    keys = round_keys(KEY_ROUNDS, SEED, device=ts.device)
    losses, ghat = [], None
    for t in range(STEPS):
        tok = rng.randint(rng.fold_in(keys[t], ref.SALT_DATA), (8, 16), 0,
                          256)
        batch = {"tokens": tok}
        params, opt_state, delta, met = ts.jitted(batch)(
            params, opt_state, delta, batch, t, keys[t])
        losses.append(float(met["global_loss"]))
        if t == 0:
            ghat = [m.clone() for m in tree_leaves(opt_state["m"])]
    return losses, ghat, tree_leaves(params)


def reference_run(device):
    cfg = ref_step.Settings.from_files(CONFIG, WORKLOAD)
    step = ref_step.Step(cfg, SEED, device)
    losses, ghat = [], None
    for t in range(STEPS):
        losses.append(step.step(t))
        if t == 0:
            ghat = [m.clone() for m in tfm.leaves(step.state["m"])]
    return losses, ghat, tfm.leaves(step.params)


def assert_bitwise(device):
    got, want = port_run(device), reference_run(device)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1], strict=True):
        assert torch.equal(a, b)
    for a, b in zip(got[2], want[2], strict=True):
        assert torch.equal(a, b)


def test_settings_from_the_cell_files():
    cfg = ref_step.Settings.from_files(CONFIG, WORKLOAD)
    assert (cfg.m, cfg.shards, cfg.s_block) == (4, 2, 64)
    with pytest.raises(ValueError):
        bad = dict(WORKLOAD, ota=dict(WORKLOAD["ota"], layout="sliced"))
        ref_step.Settings.from_files(CONFIG, bad)


def test_xla_sum_order():
    """Windows of 32 from a zero-padded front, then their sums the same
    way: on 100 entries, 14 zeros in front."""
    x = torch.arange(1, 101, dtype=torch.float32) / 7
    pad = torch.cat([torch.zeros(14), x, torch.zeros(14)]).view(4, 32)
    acc = pad[:, 0] + 0.0
    for i in range(1, 32):
        acc = acc + pad[:, i]
    want = ((acc[0] + acc[1]) + acc[2]) + acc[3]
    assert torch.equal(ref_step.xla_sum(x), want)


def test_three_steps_equal_the_port_on_cpu():
    assert_bitwise("cpu")


@pytest.mark.cuda
def test_three_steps_equal_the_port_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert_bitwise("cuda")


def test_step_spans():
    """The step is a ``round`` span holding ``step.grads`` and
    ``step.aggregate``, opened in the calling thread."""
    from repro_torch import tracing

    arch = ArchConfig(name="tiny", family="dense", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=1, d_ff=64, vocab=64,
                      head_dim=16, tie_embeddings=True)
    ts = make_train_step(arch, TrainConfig(), OTAConfig(scheme="ideal"),
                         Mesh((2, 1), ("data", "model")), device="cpu")
    params, opt_state, delta = ts.init_state(rng.PRNGKey(0))
    batch = {"tokens": rng.randint(rng.PRNGKey(1), (2, 8), 0, 64)}
    tracing.clear()
    tracing.enable()
    try:
        ts.jitted(batch)(params, opt_state, delta, batch, 3,
                         rng.PRNGKey(2))
    finally:
        tracing.disable()
    spans = tracing.last_round()["spans"]
    assert [(s["name"], s["parent"], s["t"]) for s in spans] == [
        ("round", None, 3), ("step.grads", 0, 3), ("step.aggregate", 0, 3)]
    tracing.clear()


@pytest.mark.parametrize("seed", [0, 12345, 0xFFFFFFFF])
def test_int32_hash_equals_the_block_matrices(seed):
    from fedbench.reference import ota

    for b0, n, s, c in ((0, 3, 64, 256), (88000, 2, 16, 4096)):
        assert torch.equal(
            ref_step.block_matrices(seed, b0, n, s, c, "cpu"),
            ota.block_matrices(seed, b0, n, s, c, "cpu"))
