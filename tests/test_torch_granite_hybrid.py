"""granite-4.0-h's hybrid decoder in the port against its plain reference
(``tests/torch_granite_hybrid_ref.py``, a copy of the benchmark's
``fedbench/reference/granite_hybrid.py``) on seeded random weights at a
small size: the init leaf for leaf, then the logits, the loss and every
leaf's gradient.  The port runs the published Mamba2 mixer's chunked SSD.
The reference has two forms of the SSD: its recurrence one step at a
time (``ssd_scan``), and the recurrence unrolled in the program's chunks
and summation order (``ssd_chunked``, which the benchmark's check runs).

Against the chunked form the port is bit for bit, in float32 and in
bfloat16 compute alike (``test_chunked_reference_bitwise``), so the
benchmark's check can hold the program to the float32 rounding of its
own sums.  Against the recurrence, the independent check:

Tolerances, float32 compute: the two sum the same terms of the SSD in
other orders (segment sums and chunk states against a running state), so
they part by float32 rounding alone, carried through at most ten layers:
measured at most 1.1e-6 of the largest logit and 1.4e-5 of a leaf's
largest gradient entry.  The bars are 1e-5 of the largest logit, 1e-4 of
each leaf's largest gradient entry and 1e-6 relative for the loss; a
bfloat16 computation misses them by orders of magnitude
(``test_bfloat16_misses_the_float32_bars``).  Attention alone has no SSD,
and equals the reference bit for bit.

The new config fields at their defaults leave the dense, MoE and zamba2
forwards bitwise as they were: digests of their loss, logits and
gradients, taken before the fields existed, on one CPU thread.

The ``cuda`` case runs the same comparison on the card and skips without
one.
"""
import dataclasses
import hashlib
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch_granite_hybrid_ref as R  # noqa: E402
from fedbench.reference.transformer import leaf_names, leaves  # noqa: E402
from repro_torch import rng, tracing  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ATTN, MAMBA2_MLP, ArchConfig, SSMConfig, get_config,
)
from repro_torch.convert import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train.trainer import abstract_params, ravel_meta  # noqa: E402

LOGIT_BAR, GRAD_BAR, LOSS_BAR = 1e-5, 1e-4, 1e-6
PERIOD = ["mamba"] * 5 + ["attention"] + ["mamba"] * 4
GRANITE = dict(e=12.0, a=0.015625, r=0.22, l=8.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_config(types, groups=1, e=1.0, a=0.25, r=1.0, l=1.0, chunk=8):
    """A small configuration in the published keys."""
    return dict(num_hidden_layers=len(types), layer_types=list(types),
                hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                shared_intermediate_size=96, vocab_size=128,
                rms_norm_eps=1e-5, mamba_n_heads=8, mamba_d_head=16,
                mamba_d_state=8, mamba_n_groups=groups, mamba_d_conv=4,
                mamba_expand=2, mamba_chunk_size=chunk,
                embedding_multiplier=e, attention_multiplier=a,
                residual_multiplier=r, logits_scaling=l,
                position_embedding_type="nope")


def port_arch(hf) -> ArchConfig:
    return ArchConfig(
        name="tiny-hybrid", family="hybrid", n_layers=hf["num_hidden_layers"],
        d_model=hf["hidden_size"], n_heads=hf["num_attention_heads"],
        n_kv_heads=hf["num_key_value_heads"],
        d_ff=hf["shared_intermediate_size"], vocab=hf["vocab_size"],
        head_dim=hf["hidden_size"] // hf["num_attention_heads"],
        tie_embeddings=True, norm_eps=hf["rms_norm_eps"],
        block_pattern=tuple(ATTN if t == "attention" else MAMBA2_MLP
                            for t in hf["layer_types"]),
        ssm=SSMConfig(d_state=hf["mamba_d_state"], expand=hf["mamba_expand"],
                      head_dim=hf["mamba_d_head"],
                      conv_width=hf["mamba_d_conv"],
                      chunk=hf["mamba_chunk_size"], published=True,
                      n_groups=hf["mamba_n_groups"]),
        embedding_multiplier=hf["embedding_multiplier"],
        attention_multiplier=hf["attention_multiplier"],
        residual_multiplier=hf["residual_multiplier"],
        logits_scaling=hf["logits_scaling"], position_embedding="nope")


def gaps(hf, L=20, dtype=torch.float32, device="cpu", seed=11, ssd="scan"):
    """The port's and the reference's init (asserted equal), then the
    gaps of the logits, the loss and each leaf's gradient; the reference
    runs the SSD's form ``ssd``."""
    pa = port_arch(hf)
    ra = dataclasses.replace(R.Arch.from_config(hf), ssd=ssd)
    pp = model_lib.init_params(pa, rng.PRNGKey(seed, device=device))
    rp = R.init_params(ra, seed, device)
    assert [n for n in leaf_names(rp)] == sorted(leaf_names(rp))
    for a, b in zip(tree_leaves(pp), leaves(rp), strict=True):
        assert torch.equal(a, b)
    tok = rng.randint(rng.PRNGKey(seed + 1, device=device), (2, L), 0,
                      ra.vocab)
    p = tree_map(lambda t: t.detach().requires_grad_(True), pp)
    loss_p, _ = model_lib.loss_fn(p, pa, {"tokens": tok},
                                  compute_dtype=dtype, remat=True)
    grads_p = torch.autograd.grad(loss_p, tree_leaves(p))
    q = tree_map(lambda t: t.detach().requires_grad_(True), rp)
    loss_r = R.loss(q, ra, tok, dtype)
    grads_r = torch.autograd.grad(loss_r, leaves(q))
    with torch.no_grad():
        lg_p = transformer.forward(pp, pa, tok, compute_dtype=dtype)[0]
        lg_r = R.logits(rp, ra, tok, dtype)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    return {"logits": rel(lg_p[:, :-1], lg_r),
            "loss": abs(float(loss_p.detach()) - float(loss_r.detach()))
            / float(loss_r.detach()),
            "grads": {n: rel(a, b) for n, a, b in
                      zip(leaf_names(rp), grads_p, grads_r, strict=True)}}


def assert_within_bars(g):
    assert g["logits"] <= LOGIT_BAR, g["logits"]
    assert g["loss"] <= LOSS_BAR, g["loss"]
    worst = max(g["grads"], key=g["grads"].get)
    assert g["grads"][worst] <= GRAD_BAR, (worst, g["grads"][worst])


def test_reference_copies_equal():
    assert ((ROOT / "tests" / "torch_granite_hybrid_ref.py").read_bytes()
            == (ROOT / "fedbench" / "reference" / "granite_hybrid.py")
            .read_bytes())


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_xbc_conv_groups(groups):
    assert_within_bars(gaps(hf_config(["mamba", "mamba"], groups=groups)))


@pytest.mark.parametrize("L", [8, 16, 20, 5],
                         ids=["1chunk", "2chunks", "3chunks_partial",
                              "1chunk_partial"])
def test_ssd_chunks(L):
    assert_within_bars(gaps(hf_config(["mamba", "mamba"]), L=L))


def test_ssd_chunk_counter():
    tracing.reset("ssd.chunks")
    gaps(hf_config(["mamba", "attention", "mamba"]), L=20)
    # 3 chunks of 8 a Mamba layer's forward: two layers, each run in the
    # forward, its remat recompute, and the logits' forward
    assert tracing.totals()["ssd.chunks"] == 3 * 2 * 3


def test_nope_attention_bitwise():
    """Attention with no position embedding under attention_multiplier
    has no SSD: bit for bit."""
    g = gaps(hf_config(["attention", "attention"], a=0.015625))
    assert g["logits"] == 0.0 and g["loss"] == 0.0
    assert max(g["grads"].values()) == 0.0


@pytest.mark.parametrize("which", ["e", "a", "r", "l"])
def test_each_multiplier_alone(which):
    assert_within_bars(gaps(hf_config(["mamba", "attention"],
                                      **{which: GRANITE[which]})))


def test_published_period_cut_to_ten_layers():
    assert_within_bars(gaps(hf_config(PERIOD, **GRANITE)))


def test_bfloat16_misses_the_float32_bars():
    """The bars separate the configured float32 from bfloat16: the port in
    bfloat16 against the reference in float32."""
    hf = hf_config(PERIOD, **GRANITE)
    pa, ra = port_arch(hf), R.Arch.from_config(hf)
    pp = model_lib.init_params(pa, rng.PRNGKey(11))
    tok = rng.randint(rng.PRNGKey(12), (2, 20), 0, ra.vocab)
    with torch.no_grad():
        lo = transformer.forward(pp, pa, tok,
                                 compute_dtype=torch.bfloat16)[0][:, :-1]
        hi = R.logits(R.init_params(ra, 11, "cpu"), ra, tok, torch.float32)
    assert float((lo - hi).abs().max() / hi.abs().max()) > 100 * LOGIT_BAR


CHUNKED = {
    "groups1": (dict(types=["mamba", "mamba"]), 20),
    "groups2": (dict(types=["mamba", "mamba"], groups=2), 20),
    "1chunk_partial": (dict(types=["mamba", "mamba"]), 5),
    "2chunks": (dict(types=["mamba", "mamba"]), 16),
    "period": (dict(types=PERIOD, groups=2, **GRANITE), 20),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_reference_bitwise(case, dtype):
    """The reference's chunked SSD sums as the program does: logits, loss
    and every leaf's gradient equal bit for bit, bfloat16 compute too."""
    kw, L = CHUNKED[case]
    kw = dict(kw)
    g = gaps(hf_config(kw.pop("types"), **kw), L=L, dtype=dtype,
             ssd="chunked")
    assert g["logits"] == 0.0 and g["loss"] == 0.0
    assert max(g["grads"].values()) == 0.0, g["grads"]


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("L", [1, 7, 8, 9, 30])
def test_chunked_ssd_is_the_recurrence(L, groups):
    """The chunked form against the step-by-step recurrence on random
    float32 inputs, chunks of 8: the same terms summed in other orders,
    so they part by float32 rounding alone (measured at most 2.2e-7 of
    the largest output at these sizes; the bar is 1e-5)."""
    gen = torch.Generator().manual_seed(L * 10 + groups)
    H, P, N = 8, 4, 6
    x = torch.randn(2, L, H, P, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(2, L, H, generator=gen))
    a = -torch.exp(torch.randn(H, generator=gen))
    b = torch.randn(2, L, groups, N, generator=gen)
    c = torch.randn(2, L, groups, N, generator=gen)
    want = R.ssd_scan(x, dt, a, b, c)
    got = R.ssd_chunked(x, dt, a, b, c, 8)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_published_config_counts():
    """The published config: 40 layers, attention at 5, 15, 25 and 35; its
    first ten layers at published widths hold 951 991 232 parameters, 227
    chunks of 2**22."""
    cfg = get_config("granite_4_0_h_micro")
    kinds = cfg.blocks()
    assert [i for i, k in enumerate(kinds) if k == ATTN] == [5, 15, 25, 35]
    cut = dataclasses.replace(cfg, n_layers=10,
                              block_pattern=cfg.block_pattern[:10])
    d, _ = ravel_meta(abstract_params(cut))
    assert d == 951_991_232 and -(-d // 2**22) == 227


#: digests of the loss, logits and gradients of the reduced configs, taken
#: before the granite-4.0-h fields existed (seed 5, tokens (2, 12) of seed
#: 6, remat, one CPU thread)
DIGESTS = {
    "smollm_360m:float32": "664e969dc256a8c1",
    "smollm_360m:bfloat16": "31b11a7c238a8452",
    "granite_moe_1b_a400m:float32": "b0031f21118771b2",
    "granite_moe_1b_a400m:bfloat16": "e5ed76d04b8ff665",
    "zamba2_7b:float32": "744de6de1cbcd7ed",
    "zamba2_7b:bfloat16": "198d9a8aff1ad1f4",
}


@pytest.mark.parametrize("case", sorted(DIGESTS))
def test_defaults_bitwise_as_before(case):
    arch, dt = case.split(":")
    cfg = get_config(arch).reduced()
    dtype = getattr(torch, dt)
    p = tree_map(lambda a: a.detach().requires_grad_(True),
                 model_lib.init_params(cfg, rng.PRNGKey(5)))
    tok = rng.randint(rng.PRNGKey(6), (2, 12), 0, cfg.vocab)
    loss, _ = model_lib.loss_fn(p, cfg, {"tokens": tok}, compute_dtype=dtype,
                                remat=True)
    g = torch.autograd.grad(loss, tree_leaves(p))
    lg, _, _ = transformer.forward(p, cfg, tok, compute_dtype=dtype)
    h = hashlib.sha256()
    for t in [loss.detach(), lg.detach()] + list(g):
        h.update(t.detach().float().contiguous().numpy().tobytes())
    assert h.hexdigest()[:16] == DIGESTS[case]


@pytest.mark.cuda
def test_period_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert_within_bars(gaps(hf_config(PERIOD, groups=2, **GRANITE), L=40,
                            device="cuda"))


@pytest.mark.cuda
def test_chunked_reference_bitwise_on_card():
    """The benchmark's check on the card: the published period in
    bfloat16 compute over 5 chunks, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = gaps(hf_config(PERIOD, groups=2, **GRANITE), L=40,
             dtype=torch.bfloat16, device="cuda", ssd="chunked")
    assert g["logits"] == 0.0 and g["loss"] == 0.0
    assert max(g["grads"].values()) == 0.0, g["grads"]


def test_round_spans_and_counter():
    """A tiny hybrid's streamed round with the tracer armed: each mixer's
    forward is a ``model.mamba`` or ``model.attention`` span under the
    devices' ``grads.forward`` (on the CPU the backward's recompute runs
    in the calling thread, so under ``grads.backward`` too), and the SSD
    counts its chunks."""
    from repro_torch.configs.base import OTAConfig, TrainConfig
    from repro_torch.experiments.engine import round_keys
    from repro_torch.train.fedllm import CompiledFedLLM

    fed = CompiledFedLLM(port_arch(hf_config(["mamba", "attention"])),
                         TrainConfig(), OTAConfig(scheme="ideal"), m=2,
                         batch=1, seq_len=20, chunk_size=1 << 16,
                         device="cpu")
    tracing.clear()
    tracing.enable()
    try:
        fed.run_segment({}, round_keys(1, 0, device="cpu"), None,
                        fed.carry0(), 0)
    finally:
        tracing.disable()
    rec = tracing.last_round()
    spans = rec["spans"]
    names = [s["name"] for s in spans]
    parent = {s["name"]: spans[s["parent"]]["name"] for s in spans
              if s["parent"] is not None and s["name"].startswith("model.")}
    assert parent == {"model.mamba": "grads.backward",
                      "model.attention": "grads.backward"}
    fwd = [spans[s["parent"]]["name"] for s in spans
           if s["name"] == "model.mamba"]
    assert fwd.count("grads.forward") == 2     # one layer, two devices
    assert names.count("model.attention") == 4  # forward and recompute
    assert rec["counters"]["ssd.chunks"] == 3 * 2 * 2
    tracing.clear()
