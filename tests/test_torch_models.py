"""The port's zoo configs, model RNG and models against the JAX package
(``repro.configs``, ``jax.random``, ``repro.models``).

Held against the live reference on the CPU:

* every config (ten zoo archs and mnist_mlp, full and ``reduced()``) field
  for field, with ``approx_param_count``, ``active_param_count`` and
  ``ota_overrides``; ``TrainConfig``, ``ShapeConfig`` and ``INPUT_SHAPES``;
* ``rng.randint`` and ``rng.truncated_normal`` bitwise (stacked keys as
  ``jax.vmap`` draws them);
* ``ravel_meta``'s d, leaf order and unraveller against ``ravel_pytree``;
* ``init_params`` bitwise on the ten archs' reduced configs, and on
  zamba2 with a tail (``n_layers`` 5, the shared block used twice, then one
  Mamba2 layer); ``abstract_params`` of the four MoE, Mamba2, RWKV6 and
  hybrid archs at their published widths against ``jax.eval_shape``;
* from the reference's params: the float32 loss within 1e-5 relative (the
  reference under ``jit``), the flattened gradient within rtol 1e-4 / atol
  1e-6, ``remat`` on and off bitwise in the port, ``loss_chunk`` within
  1e-6 relative of the unchunked loss, and the bfloat16 loss within 1e-3
  relative (measured: at most 5.6e-4, rwkv6; the two packages round
  their bfloat16 products and casts differently).  Two gradients cancel
  below the absolute bar in a few entries (ROADMAP §3): zamba2's (the SSD
  turns the products' last-bit differences into ~1e-5 relative ones in its
  decays) and rwkv6's (the bonus ``u`` sums ~100-sized terms to 0.05, and
  the reference's own remat on and off differ there by 9e-5).  There the
  bar is ``GRAD_GAPS``: a count of entries that may leave it, each within a
  stated multiple of its leaf's largest magnitude.

``init_cache`` builds every arch's decode states and a forward runs with
them; the decode path is held against the reference in
``tests/test_torch_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs import base as jbase
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.optim.optim import make_optimizer as jmake_optimizer
from repro_torch import rng
from repro_torch.configs import base as tbase
from repro_torch.convert import (
    ravel, to_numpy, to_torch, tree_leaves, tree_map,
)
from repro_torch.models import model as tmodel
from repro_torch.models import transformer
from repro_torch.optim.optim import make_optimizer
from repro_torch.train.trainer import abstract_params, ravel_meta

ATTN_ARCHS = ("smollm_360m", "qwen3_8b", "yi_34b", "mistral_large_123b",
              "qwen2_vl_7b", "whisper_base")
OTHER_ARCHS = ("zamba2_7b", "granite_moe_1b_a400m", "granite_moe_3b_a800m",
               "rwkv6_3b")
ALL_CONFIGS = tbase.ARCH_IDS + ("mnist_mlp",)
#: the parity cases: each arch's reduced config, and zamba2 with a tail
TAIL = "zamba2_7b+tail"
CASES = ATTN_ARCHS + OTHER_ARCHS + (TAIL,)

F32_LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
CHUNK_RTOL = 1e-6
#: measured: 5.6e-4 at most (rwkv6_3b), 3.7e-4 qwen2_vl_7b, 1e-5 to 1.2e-4
#: elsewhere
BF16_LOSS_RTOL = 1e-3
#: per arch: how many gradient entries may leave rtol 1e-4 / atol 1e-6
#: (None: any), each then within the given multiple of its leaf's largest
#: magnitude.  Measured: rwkv6 3 of 470 400 entries, at most 1.0e-6 of the
#: leaf's scale (``u``; the card against the CPU port: 5, 3.1e-6); zamba2 31
#: of 505 520 (1.1e-5, ``embed``; the card: 24, 7.8e-6) and with a tail 864
#: of 1 139 568 (2.6e-5, ``embed``); 0 for the other archs.
GRAD_GAPS = {"rwkv6_3b": (8, 5e-6), "zamba2_7b": (None, 5e-5),
             TAIL: (None, 5e-5)}


def _cfgs(case):
    """The reference's and the port's config of a parity case."""
    arch = case.split("+")[0]
    jc, tc = jbase.get_config(arch).reduced(), tbase.get_config(arch).reduced()
    if case == TAIL:
        jc = dataclasses.replace(jc, n_layers=5)
        tc = dataclasses.replace(tc, n_layers=5)
    return jc, tc


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module on one intra-op thread, its module-scoped references
    too (thousands of small ops, which a parallel run's busy cores slow
    with a pool of threads to wake)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_arch_ids_equal_reference():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert set(OTHER_ARCHS) | set(ATTN_ARCHS) == set(tbase.ARCH_IDS)


@pytest.mark.parametrize("arch", ALL_CONFIGS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_equal_reference(arch, reduced):
    jc, tc = jbase.get_config(arch), tbase.get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.blocks() == jc.blocks()
    assert tc.resolved_head_dim == jc.resolved_head_dim
    assert tbase.approx_param_count(tc) == jbase.approx_param_count(jc)
    assert tbase.active_param_count(tc) == jbase.active_param_count(jc)
    if not reduced:
        assert (dataclasses.asdict(tbase.ota_overrides(arch))
                == dataclasses.asdict(jbase.ota_overrides(arch)))


def test_train_and_shape_configs_equal_reference():
    assert (dataclasses.asdict(tbase.TrainConfig())
            == dataclasses.asdict(jbase.TrainConfig()))
    assert {k: dataclasses.asdict(v) for k, v in tbase.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    tc = tbase.TrainConfig(optimizer="momentum", lr=0.3, warmup_steps=4,
                           total_steps=9, weight_decay=0.1, grad_clip=2.0)
    jc = jbase.TrainConfig(**dataclasses.asdict(tc))
    assert (dataclasses.asdict(make_optimizer(tc))
            == dataclasses.asdict(jmake_optimizer(jc)))


# ---------------------------------------------------------------------------
# the model RNG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("shape", [(5,), (2, 8), (64, 33)])
@pytest.mark.parametrize("lo,hi", [(0, 512), (0, 49152), (0, 151936),
                                   (-5, 3), (3, 3), (0, 2 ** 31 - 1),
                                   (-2 ** 31, 2 ** 31 - 1)])
def test_randint_bitwise(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                         lo, hi))
    got = rng.randint(rng.PRNGKey(seed), shape, lo, hi).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _stack(keys):
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


def test_randint_stacked_keys_bitwise():
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jax.random.randint(k, (2, 16), 0, 49152)))(keys))
    np.testing.assert_array_equal(
        rng.randint(_stack(keys), (2, 16), 0, 49152).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 99])
@pytest.mark.parametrize("shape", [(7,), (32, 96), (128, 256)])
def test_truncated_normal_bitwise(seed, shape):
    want = np.asarray(jax.random.truncated_normal(
        jax.random.PRNGKey(seed), -2.0, 2.0, shape, jnp.float32))
    got = rng.truncated_normal(rng.PRNGKey(seed), -2.0, 2.0, shape).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() > -2.0 and got.max() < 2.0


def test_truncated_normal_stacked_keys_bitwise():
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    want = np.asarray(jax.vmap(lambda k: jax.random.truncated_normal(
        k, -2.0, 2.0, (64, 48)))(keys))
    np.testing.assert_array_equal(
        rng.truncated_normal(_stack(keys), -2.0, 2.0, (64, 48)).numpy(),
        want)


# ---------------------------------------------------------------------------
# the flat layout and the init
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_params():
    """The reference's params of each parity case."""
    return {a: jax.device_get(jmodel.init_params(_cfgs(a)[0],
                                                 jax.random.PRNGKey(0)))
            for a in CASES}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


@pytest.mark.parametrize("arch", CASES)
def test_ravel_meta_order_equals_ravel_pytree(ref_params, arch):
    cfg = _cfgs(arch)[1]
    aparams = abstract_params(cfg)
    d, unravel = ravel_meta(aparams)
    want = ref_params[arch]
    jpaths = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(want)[0]]
    assert _paths(aparams) == jpaths
    assert [tuple(x.shape) for x in tree_leaves(aparams)] == \
        [tuple(x.shape) for x in jax.tree.leaves(want)]
    assert all(x.device.type == "meta" for x in tree_leaves(aparams))
    jflat, junravel = ravel_pytree(want)
    assert d == jflat.shape[0]
    flat = np.random.default_rng(1).standard_normal(d).astype(np.float32)
    got, wtree = unravel(torch.from_numpy(flat)), junravel(jnp.asarray(flat))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(wtree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ravel(got).numpy(), flat)
    np.testing.assert_array_equal(
        ravel(to_torch(want, "cpu")).numpy(), np.asarray(jflat))


def test_ravel_meta_full_width_smollm():
    """d of smollm-360m at its published widths, from shapes alone."""
    d, _ = ravel_meta(abstract_params(tbase.get_config("smollm_360m")))
    assert d == 361_821_120


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_abstract_params_full_width_equal_eval_shape(arch):
    """The published widths' param tree from shapes alone, leaf for leaf
    the reference's ``jax.eval_shape`` of its init, and nothing allocated."""
    cfg = tbase.get_config(arch)
    aparams = abstract_params(cfg)
    want = jax.eval_shape(lambda k: jmodel.init_params(
        jbase.get_config(arch), k), jax.random.PRNGKey(0))
    assert _paths(aparams) == [tuple(k.key for k in p) for p, _ in
                               jax.tree_util.tree_flatten_with_path(want)[0]]
    assert [tuple(x.shape) for x in tree_leaves(aparams)] == \
        [tuple(x.shape) for x in jax.tree.leaves(want)]
    assert all(x.device.type == "meta" for x in tree_leaves(aparams))
    assert ravel_meta(aparams)[0] == sum(x.size for x in
                                         jax.tree.leaves(want))


@pytest.mark.parametrize("arch", CASES)
def test_init_params_bitwise(ref_params, arch):
    got = tmodel.init_params(_cfgs(arch)[1], rng.PRNGKey(0, device="cpu"))
    want = ref_params[arch]
    assert _paths(got) == [tuple(k.key for k in p) for p, _ in
                           jax.tree_util.tree_flatten_with_path(want)[0]]
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tmodel.param_count(got) == jmodel.param_count(want)


# ---------------------------------------------------------------------------
# loss and gradient from the reference's params
# ---------------------------------------------------------------------------


def _batch(cfg, seed, B=2, L=12):
    r = np.random.default_rng(seed)
    b = {"tokens": r.integers(0, cfg.vocab, (B, L)).astype(np.int32)}
    if cfg.mrope_sections is not None:
        P = cfg.n_vision_tokens
        b["extra"] = (0.02 * r.standard_normal((B, P, cfg.d_model))).astype(
            np.float32)
        b["positions"] = np.broadcast_to(
            np.arange(P + L)[None, :, None], (B, P + L, 3)).astype(np.int32)
    if cfg.encoder is not None:
        b["frames"] = (0.02 * r.standard_normal(
            (B, cfg.encoder.n_frames, cfg.encoder.d_model))).astype(
                np.float32)
    return b


@pytest.fixture(scope="module")
def ref_losses(ref_params):
    """The reference under ``jit``: the float32 loss and gradient (remat
    on) and the bfloat16 loss, per parity case."""
    out = {}
    for a in CASES:
        cfg = _cfgs(a)[0]
        p, b = ref_params[a], _batch(cfg, 1)
        l32, g = jax.jit(jax.value_and_grad(lambda p: jmodel.loss_fn(
            p, cfg, b, compute_dtype=jnp.float32, remat=True)[0]))(p)
        l16 = jax.jit(lambda p: jmodel.loss_fn(
            p, cfg, b, compute_dtype=jnp.bfloat16, remat=False)[0])(p)
        out[a] = dict(loss={"float32": float(l32), "bfloat16": float(l16)},
                      grad=np.asarray(ravel_pytree(g)[0]), batch=b)
    return out


def _port_loss(arch, params, batch, dtype=torch.float32, **kw):
    cfg = _cfgs(arch)[1]
    return tmodel.loss_fn(params, cfg, to_torch(batch, "cpu"),
                          compute_dtype=dtype, **kw)


def _port_grad(arch, ref_params, batch, remat):
    p = tree_map(lambda a: a.requires_grad_(True),
                 to_torch(ref_params, "cpu"))
    loss, _ = _port_loss(arch, p, batch, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    return loss.detach(), torch.cat([g.reshape(-1) for g in grads])


@pytest.mark.parametrize("arch", CASES)
def test_loss_f32_matches_reference(ref_params, ref_losses, arch):
    want = ref_losses[arch]
    loss, met = _port_loss(arch, to_torch(ref_params[arch], "cpu"),
                           want["batch"], remat=False)
    np.testing.assert_allclose(float(loss), want["loss"]["float32"],
                               rtol=F32_LOSS_RTOL)
    if _cfgs(arch)[1].moe is None:
        assert float(met["aux"]) == 0.0 and float(met["loss"]) == float(loss)
    else:
        jc = _cfgs(arch)[0]
        _, jmet = jax.jit(lambda p: jmodel.loss_fn(
            p, jc, want["batch"], compute_dtype=jnp.float32,
            remat=False))(ref_params[arch])
        np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                                   rtol=F32_LOSS_RTOL)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=F32_LOSS_RTOL)
        assert float(met["aux"]) > 0


def _assert_grad_close(arch, ref_params, got, want):
    """rtol 1e-4 / atol 1e-6, or the arch's ``GRAD_GAPS``."""
    if arch not in GRAD_GAPS:
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        return
    count, scale_atol = GRAD_GAPS[arch]
    out = np.abs(got - want) > GRAD_ATOL + GRAD_RTOL * np.abs(want)
    assert count is None or out.sum() <= count, int(out.sum())
    off = 0
    for leaf in jax.tree.leaves(ref_params[arch]):
        w, g = want[off:off + leaf.size], got[off:off + leaf.size]
        np.testing.assert_allclose(
            g, w, rtol=GRAD_RTOL,
            atol=max(GRAD_ATOL, scale_atol * np.abs(w).max()))
        off += leaf.size


@pytest.mark.parametrize("arch", CASES)
def test_grad_f32_matches_reference_and_remat_is_exact(ref_params,
                                                       ref_losses, arch):
    want = ref_losses[arch]
    l_on, g_on = _port_grad(arch, ref_params[arch], want["batch"], True)
    l_off, g_off = _port_grad(arch, ref_params[arch], want["batch"], False)
    _assert_grad_close(arch, ref_params, g_on.numpy(), want["grad"])
    assert torch.equal(l_on, l_off) and torch.equal(g_on, g_off)


@pytest.mark.parametrize("arch", CASES)
def test_loss_chunk_equals_unchunked(ref_params, ref_losses, arch):
    params = to_torch(ref_params[arch], "cpu")
    batch = ref_losses[arch]["batch"]
    whole, _ = _port_loss(arch, params, batch, remat=False)
    for ck in (5, 8):       # 22 targets: chunks of 2 and of 11
        part, _ = _port_loss(arch, params, batch, remat=False, loss_chunk=ck)
        np.testing.assert_allclose(float(part), float(whole), rtol=CHUNK_RTOL)


@pytest.mark.parametrize("arch", CASES)
def test_loss_bf16_matches_reference(ref_params, ref_losses, arch):
    loss, _ = _port_loss(arch, to_torch(ref_params[arch], "cpu"),
                         ref_losses[arch]["batch"], dtype=torch.bfloat16,
                         remat=True)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss),
                               ref_losses[arch]["loss"]["bfloat16"],
                               rtol=BF16_LOSS_RTOL)


def test_forward_logits_shape_and_head():
    cfg = tbase.get_config("smollm_360m").reduced()
    params = tmodel.init_params(cfg, rng.PRNGKey(0, device="cpu"))
    toks = torch.zeros((2, 16), dtype=torch.int32)
    logits, cache, aux = transformer.forward(params, cfg, toks,
                                             compute_dtype=torch.float32)
    assert logits.shape == (2, 16, cfg.vocab) and cache is None
    jcfg = jbase.get_config("smollm_360m").reduced()
    want = jax.jit(lambda p: jtransformer.forward(
        p, jcfg, jnp.zeros((2, 16), jnp.int32),
        compute_dtype=jnp.float32)[0])(to_numpy(params))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_optimizer_on_nested_params_matches_reference(ref_params):
    """Adam (no warmup) on a nested tree, one step from the reference's
    params and a seeded gradient, against the reference under ``jit``:
    within rtol 1e-6 / atol 1e-7."""
    tc = tbase.TrainConfig(warmup_steps=0, lr=1e-2)
    p = ref_params["qwen2_vl_7b"]
    g = jax.tree.map(lambda x: np.random.default_rng(x.size).standard_normal(
        x.shape).astype(np.float32), p)
    jopt = jmake_optimizer(jbase.TrainConfig(**dataclasses.asdict(tc)))
    want, wstate = jax.jit(jopt.apply)(p, g, jopt.init(p))
    opt = make_optimizer(tc)
    tp = to_torch(p, "cpu")
    got, state = opt.apply(tp, to_torch(g, "cpu"), opt.init(tp))
    assert _paths(got) == _paths(jax.device_get(want))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert int(state["count"]) == int(wstate["count"]) == 1


# ---------------------------------------------------------------------------
# the decode states (held against the reference in test_torch_serve.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_init_cache_raises_naming_the_serve_slice(arch):
    """Once raised until the serve slice landed; now every arch's decode
    states build, stacked over the layers, and a forward with them runs one
    step and writes the caches."""
    cfg = tbase.get_config(arch).reduced()
    cache = transformer.init_cache(cfg, 1, 8, device="cpu")
    assert all(leaf.shape[0] in (cfg.n_layers, cfg.n_layers // max(
        cfg.shared_attn_every, 1)) for leaf in tree_leaves(cache))
    params = tmodel.init_params(cfg, rng.PRNGKey(0, device="cpu"))
    enc_out = None
    if cfg.encoder is not None:
        enc_out = torch.zeros((1, cfg.encoder.n_frames, cfg.d_model))
    out, new, _ = transformer.forward(
        params, cfg, torch.zeros((1, 1), dtype=torch.int32), cache=cache,
        cache_index=0, enc_out=enc_out, compute_dtype=torch.float32)
    assert tuple(out.shape) == (1, 1, cfg.vocab)
    kv = new.get("kv", new.get("shared"))
    if kv is not None:
        assert bool((kv["pos"][..., 0] == 0).all())


def test_hybrid_shared_block_runs_n_layers_over_every_times(monkeypatch):
    """zamba2 with 5 layers and every 2: the shared block twice, after
    layers 2 and 4, and layer 5 as the tail; a Mamba2 layer is
    rematerialised, the shared block is not."""
    cfg = _cfgs(TAIL)[1]
    params = tmodel.init_params(cfg, rng.PRNGKey(0, device="cpu"))
    calls = []
    apply_block, shared = transformer.apply_block, \
        transformer._apply_shared_attn

    def spy_block(*a, **kw):
        calls.append("mamba")
        return apply_block(*a, **kw)

    def spy_shared(*a, **kw):
        calls.append("shared")
        return shared(*a, **kw)

    monkeypatch.setattr(transformer, "apply_block", spy_block)
    monkeypatch.setattr(transformer, "_apply_shared_attn", spy_shared)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    transformer.forward(params, cfg, toks, compute_dtype=torch.float32)
    assert calls == ["mamba", "mamba", "shared", "mamba", "mamba", "shared",
                     "mamba"]
    calls.clear()
    p = tree_map(lambda a: a.requires_grad_(True), params)
    out, _, _ = transformer.forward(p, cfg, toks, compute_dtype=torch.float32,
                                    remat=True)
    out.sum().backward()
    # backward recomputes each of the five Mamba2 layers once
    assert calls.count("mamba") == 10 and calls.count("shared") == 2
