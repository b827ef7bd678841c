"""The serve path (``repro_torch.models`` decode, ``repro_torch.train.serve``,
``repro_torch.sharding.specs``, ``repro_torch.launch.mesh`` and
``fedllm.serve_while_train``) against the JAX package on the CPU.

The reference's serve pieces run on a 1 x 1 mesh with Auto axes, built
here: the reference's own ``make_local_mesh`` makes Explicit axes on jax
0.9.0, where its KV-cache update fails (ROADMAP, North star).  Inputs are
drawn from a numpy seed; params are the reference's, carried across by
``to_torch``.

Bars, each measured on these inputs:

* ``param_specs`` and ``_cache_leaf_spec``: equal, spec for spec, for the
  ten archs (reduced and published) at model sizes 1, 2, 4, 8, 16;
* ``init_decode_cache``: paths, shapes, dtypes and values equal;
* ``decode_step`` (6 steps; the reference under ``jit``): in float32 the
  logits and every cache leaf within ``F32_BAR`` = 1e-5 of the tensor's
  largest magnitude (measured at most 2.7e-6, zamba2's logits), the
  positions equal.  In bfloat16 the two packages round their products and
  casts differently (XLA keeps float32 inside its fusions), so a logit
  moves by a few bfloat16 ulps: ``BF16_BAR`` = 4e-2 of the tensor's
  largest magnitude, ten ulps at it (measured at most 2.7e-2, rwkv6's
  logits; 0.6e-2 to 1.9e-2 elsewhere), and the mean gap within
  ``BF16_MEAN_BAR`` = 8e-3 of it (measured at most 5.1e-3, rwkv6's
  logits; 1.6e-3 to 3.4e-3 elsewhere).  The dtypes of every leaf after
  every step equal the reference's (the recurrent leaves that turn
  bfloat16);
* ``prefill_fn`` / ``decode_fn`` against the reference's ``make_serve_step``
  at the same bars; the port's prefill against its own full forward at
  the last position within 2e-4 (the reference's own bar);
* ``serve_while_train`` (smollm-360m and granite-moe-1b-a400m reduced,
  float32 training, 2 rounds, m = 3): losses within 1e-5 relative (the
  stream's bar, ``tests/test_torch_fedllm.py``), ``publish_bitwise`` True,
  and the served tokens equal the reference's up to a bfloat16 tie: the
  serve batch decodes in bfloat16 (``make_serve_step``'s defaults), and
  where a token differs the port's own logits of its token and the
  reference's are within one bfloat16 ulp (``TIE_ULPS``) of each other,
  and at most ``MAX_TIES`` = 1 step of a round differs (measured: smollm's
  round 0, second token, 504 against 34, logits 0.65234375 and 0.6484375
  here, an exact tie in the reference).  Tokens after a tie follow other
  inputs and are not compared.  A resume after round 1 is bitwise the
  straight run.
"""
import contextlib
import io
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import base as jbase
from repro.configs.base import OTAConfig as JOTAConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.sharding import specs as jspecs
from repro.train import fedllm as jfedllm
from repro.train import serve as jserve
from repro.train.trainer import abstract_params as jabstract_params
from repro_torch import rng
from repro_torch.benchmarks import bench_llm
from repro_torch.configs import base as tbase
from repro_torch.configs.base import OTAConfig, TrainConfig
from repro_torch.convert import to_torch, tree_leaves, tree_map
from repro_torch.examples import serve_demo
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as tmodel
from repro_torch.models import transformer
from repro_torch.sharding import Mesh
from repro_torch.sharding import specs as tspecs
from repro_torch.train import fedllm
from repro_torch.train import serve as tserve
from repro_torch.train.trainer import abstract_params

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import check_regression  # noqa: E402

ARCHS = tbase.ARCH_IDS
MODEL_SIZES = (1, 2, 4, 8, 16)
STEPS, B, MAX_LEN = 6, 2, 8
F32_BAR = 1e-5
BF16_BAR, BF16_MEAN_BAR = 4e-2, 8e-3
PREFILL_BAR = 2e-4
LOSS_RTOL = 1e-5
TIE_ULPS, MAX_TIES = 1, 1
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SWT = dict(rounds=2, m=3, batch=2, seq_len=8, chunk_size=1 << 14,
           serve_batch=2, prompt_len=3, decode_steps=2, seed=0)
SWT_OTA = dict(projection="blocked", s_frac=0.25, k_frac=0.5, block_size=256)
CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module on one intra-op thread (many small ops, which a parallel
    run's busy cores slow with a pool of threads to wake)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])


def _cfgs(arch):
    return jbase.get_config(arch).reduced(), tbase.get_config(arch).reduced()


_PARAMS = {}


def _params(arch):
    """The reference's params of the reduced arch, and the port's copy."""
    if arch not in _PARAMS:
        jc, _ = _cfgs(arch)
        p = jax.device_get(jmodel.init_params(jc, jax.random.PRNGKey(0)))
        _PARAMS[arch] = (p, to_torch(p, "cpu"))
    return _PARAMS[arch]


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): v for p, v in flat}


def _tflat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, f"{path}['{k}']"))
        return out
    return {path: tree}


def _gap(want, got) -> tuple:
    """(largest, mean) |got - want| over want's largest magnitude."""
    a, b = _np(want), _np(got)
    scale = max(float(np.abs(a).max()), 1e-30)
    d = np.abs(a - b)
    return float(d.max()) / scale, float(d.mean()) / scale


def _assert_close(want, got, dtype: str, what: str):
    assert tuple(np.shape(want)) == tuple(got.shape), what
    if not np.issubdtype(np.asarray(want).dtype, np.floating) and \
            np.asarray(want).dtype != jnp.bfloat16:
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)
        return
    top, mean = _gap(want, got)
    if dtype == "float32":
        assert top <= F32_BAR, (what, top)
    else:
        assert top <= BF16_BAR and mean <= BF16_MEAN_BAR, (what, top, mean)


def _assert_cache_close(want, got, dtype: str, what: str):
    wf, gf = _jflat(want), _tflat(got)
    assert sorted(wf) == sorted(gf), what
    for k, w in wf.items():
        assert _dtype_name(w) == _dtype_name(gf[k]), (what, k)
        _assert_close(w, gf[k], dtype, f"{what} {k}")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def _enc_out(arch, jdt, tdt):
    """whisper's encoder output from seeded frames, in both packages."""
    jc, tc = _cfgs(arch)
    if jc.encoder is None:
        return None, None
    jp, tp = _params(arch)
    frames = (0.02 * np.random.default_rng(3).standard_normal(
        (B, jc.encoder.n_frames, jc.encoder.d_model))).astype(np.float32)
    je = jax.jit(lambda p, f: jtransformer.encode_audio(
        p, jc, f.astype(jdt)))(jp, frames)
    te = transformer.encode_audio(tp, tc, torch.from_numpy(frames).to(tdt))
    return je, te


_JDECODE = {}


def _jdecode(arch, jdt, window=None):
    """The reference's ``decode_step`` under ``jit``, one per case."""
    key = (arch, jdt, window)
    if key not in _JDECODE:
        jc, _ = _cfgs(arch)
        _JDECODE[key] = jax.jit(lambda p, t, c, pos, e: jmodel.decode_step(
            p, jc, t, c, pos, enc_out=e, compute_dtype=jdt,
            decode_window=window))
    return _JDECODE[key]


def _decode_both(arch, dtype, steps=STEPS, batch=B, max_len=MAX_LEN,
                 window=None, check=True):
    """``steps`` decode steps of both packages from seeded tokens, the
    logits and every cache leaf compared after every step."""
    jdt, tdt = DTYPES[dtype]
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    je, te = _enc_out(arch, jdt, tdt)
    toks = _tokens(jc.vocab, (batch, steps), 1)
    jcache = jmodel.init_decode_cache(jc, batch, max_len, jdt, window)
    tcache = tmodel.init_decode_cache(tc, batch, max_len, tdt, window, **CPU)
    step = _jdecode(arch, jdt, window)
    for i in range(steps):
        jl, jcache = step(jp, toks[:, i:i + 1], jcache, i, je)
        tl, tcache = tmodel.decode_step(
            tp, tc, torch.from_numpy(toks[:, i:i + 1]), tcache, i,
            enc_out=te, compute_dtype=tdt, decode_window=window)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == (
            batch, 1, jc.vocab)
        if check:
            _assert_close(jl, tl, dtype, f"{arch} step {i} logits")
            _assert_cache_close(jcache, tcache, dtype, f"{arch} step {i}")
    return jcache, tcache


# ---------------------------------------------------------------------------
# specs, the mesh
# ---------------------------------------------------------------------------


def _jspec_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _tspec_flat(tree):
    return {k: tuple(v) for k, v in _tflat(tree).items()}


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced",
                                                        "published"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_reference(arch, reduced):
    jc, tc = jbase.get_config(arch), tbase.get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    japar, tapar = jabstract_params(jc), abstract_params(tc)
    jcache = jax.eval_shape(lambda: jmodel.init_decode_cache(jc, 8, 64))
    tcache = tmodel.init_decode_cache(tc, 8, 64, device="meta")
    for size in MODEL_SIZES:
        assert _tspec_flat(tspecs.param_specs(tapar, size)) == \
            _jspec_flat(jspecs.param_specs(japar, size)), size
        for data in (1, 2):
            sizes = {"data": data, "model": size}
            want = {k: tuple(jserve._cache_leaf_spec(v.shape, ("data",),
                                                     sizes))
                    for k, v in _jflat(jcache).items()}
            got = {k: tuple(tserve._cache_leaf_spec(tuple(v.shape),
                                                    ("data",), sizes))
                   for k, v in _tflat(tcache).items()}
            assert got == want, (size, data)


def test_spec_tree_like_and_named_sharding_tree():
    mesh = make_local_mesh()
    assert mesh == Mesh((1, 1), ("data", "model")) and mesh.size == 1
    assert make_local_mesh(2, 4).shape == (2, 4)
    tree = {"a": torch.zeros(2), "b": {"c": torch.zeros(3)}}
    specs = tspecs.spec_tree_like(tree, tspecs.P("model"))
    assert _tspec_flat(specs) == {"['a']": ("model",),
                                  "['b']['c']": ("model",)}
    named = tspecs.named_sharding_tree(mesh, specs)
    assert named["b"]["c"] == tspecs.NamedSharding(mesh, tspecs.P("model"))


def test_serve_step_shardings_equal_reference():
    for arch in ("smollm_360m", "zamba2_7b"):
        jc, tc = _cfgs(arch)
        want = jserve.make_serve_step(jc, _auto_mesh(), B, MAX_LEN)
        got = tserve.make_serve_step(tc, make_local_mesh(), B, MAX_LEN,
                                     **CPU)
        for w, g in ((want.param_sharding, got.param_sharding),
                     (want.cache_sharding, got.cache_sharding)):
            wf = {k: tuple(s.spec) for k, s in _jflat(w).items()}
            gf = {k: tuple(s.spec) for k, s in _tflat(g).items()}
            assert gf == wf
            assert all(s.mesh.size == 1 for s in _tflat(g).values())


def test_serve_step_on_many_ranks_raises_naming_item_3():
    """Item 3 (the sharded trainer) has landed: on a 1 x 2 mesh the serve
    step no longer raises; its params spread over 'model' in the spec
    tree, and the placement being metadata, it decodes bitwise as on one
    rank (the 2 x 2 mesh against the reference:
    ``tests/test_torch_trainer.py``)."""
    tc = tbase.get_config("smollm_360m").reduced()
    _, tp = _params("smollm_360m")
    outs = []
    for mesh in (make_local_mesh(1, 2), make_local_mesh()):
        ts = tserve.make_serve_step(tc, mesh, B, MAX_LEN,
                                    compute_dtype=torch.float32,
                                    cache_dtype=torch.float32, **CPU)
        specs = _tspec_flat(tree_map(lambda s: s.spec, ts.param_sharding))
        assert any("model" in s for s in specs.values()) == (mesh.size > 1)
        tok = torch.from_numpy(_tokens(tc.vocab, (B, 1), 4))
        logits, _ = ts.decode_fn(ts.publish(tp), ts.init_cache(torch.float32),
                                 tok, 0)
        outs.append(logits)
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# init_decode_cache and decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_cache_equals_reference(arch, window):
    jc, tc = _cfgs(arch)
    for jdt, tdt in DTYPES.values():
        want = jax.device_get(jmodel.init_decode_cache(jc, 3, 8, jdt, window))
        got = tmodel.init_decode_cache(tc, 3, 8, tdt, window, **CPU)
        wf, gf = _jflat(want), _tflat(got)
        assert sorted(wf) == sorted(gf)
        for k, w in wf.items():
            assert _dtype_name(w) == _dtype_name(gf[k]), k
            assert tuple(w.shape) == tuple(gf[k].shape), k
            np.testing.assert_array_equal(_np(gf[k]), _np(w), err_msg=k)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, dtype):
    _decode_both(arch, dtype)


def test_ring_buffer_past_its_wrap():
    """decode_window = 4 over 7 steps: slots 0-3 are rewritten, the mask
    reads each slot's absolute position."""
    jcache, tcache = _decode_both("smollm_360m", "float32", steps=7,
                                  window=4)
    pos = tcache["kv"]["pos"]
    assert tuple(pos.shape) == (2, B, 4)
    assert pos[0, 0].tolist() == [4, 5, 6, 3]


def test_write_past_a_full_cache_clamps_to_the_last_slot():
    """No window, max_len 4, 7 steps: positions 4-6 land on slot 3, as
    ``dynamic_update_slice`` clamps its start."""
    _, tcache = _decode_both("qwen3_8b", "float32", steps=7, max_len=4)
    assert tcache["kv"]["pos"][1, 1].tolist() == [0, 1, 2, 6]


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_moe_decode_at_small_batches(batch):
    """B tokens a step: the group-size walk and the capacity at g = B."""
    _decode_both("granite_moe_1b_a400m", "float32", steps=3, batch=batch)


def test_mrope_decode_positions(monkeypatch):
    """qwen2-vl: decode_step gives attention (B, 1, 3) positions, each
    the step's position."""
    _, tc = _cfgs("qwen2_vl_7b")
    _, tp = _params("qwen2_vl_7b")
    seen = []
    attention = transformer.attention

    def spy(p, spec, x, positions, **kw):
        seen.append(positions.clone())
        return attention(p, spec, x, positions, **kw)

    monkeypatch.setattr(transformer, "attention", spy)
    cache = tmodel.init_decode_cache(tc, B, 4, torch.float32, **CPU)
    tmodel.decode_step(tp, tc, torch.zeros((B, 1), dtype=torch.int32),
                       cache, 2, compute_dtype=torch.float32)
    assert seen and all(tuple(p.shape) == (B, 1, 3) and bool((p == 2).all())
                        for p in seen)


def test_init_cache_on_meta_at_published_widths():
    """The published widths' caches come from shapes alone."""
    for arch in ("zamba2_7b", "rwkv6_3b", "whisper_base"):
        tc = tbase.get_config(arch)
        c = tmodel.init_decode_cache(tc, 4, 32, device="meta")
        assert all(leaf.device.type == "meta" for leaf in tree_leaves(c))
    zc = tmodel.init_decode_cache(tbase.get_config("zamba2_7b"), 4, 32,
                                  device="meta")
    assert zc["mamba"]["ssm_state"]["ssm"].shape[0] == 81
    assert zc["shared"]["k"].shape == (81 // 6, 4, 32, 32, 112)


# ---------------------------------------------------------------------------
# make_serve_step: prefill and decode
# ---------------------------------------------------------------------------


def _serve_both(arch, dtype, prompt_len=4, steps=2):
    """(reference, port) serve steps with their params and enc_out."""
    jdt, tdt = DTYPES[dtype]
    jc, tc = _cfgs(arch)
    n = prompt_len + steps
    js = jserve.make_serve_step(jc, _auto_mesh(), B, n, compute_dtype=jdt,
                                cache_dtype=jdt)
    ts = tserve.make_serve_step(tc, make_local_mesh(), B, n,
                                compute_dtype=tdt, cache_dtype=tdt, **CPU)
    return js, ts


def _greedy_j(logits):
    return jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)


@pytest.mark.parametrize("arch,dtype", [
    ("smollm_360m", "float32"), ("granite_moe_1b_a400m", "float32"),
    ("rwkv6_3b", "float32"), ("zamba2_7b", "float32"),
    ("whisper_base", "float32"), ("qwen2_vl_7b", "float32"),
    ("smollm_360m", "bfloat16"), ("granite_moe_1b_a400m", "bfloat16")])
def test_prefill_and_decode_match_reference_serve_step(arch, dtype):
    jdt, tdt = DTYPES[dtype]
    js, ts = _serve_both(arch, dtype)
    jp, tp = _params(arch)
    je, te = _enc_out(arch, jdt, tdt)
    jargs, targs = ((je,), (te,)) if je is not None else ((), ())
    prompt = _tokens(_cfgs(arch)[0].vocab, (B, 4), 5)
    jl, jcache = js.prefill_fn(js.publish(jax.device_put(jp)),
                               js.init_cache(jdt), prompt, *jargs)
    tl, tcache = ts.prefill_fn(ts.publish(tp), ts.init_cache(tdt),
                               torch.from_numpy(prompt), *targs)
    assert tuple(tl.shape) == (B, 1, _cfgs(arch)[0].vocab)
    _assert_close(jl, tl, dtype, "prefill logits")
    _assert_cache_close(jcache, tcache, dtype, "prefill cache")
    tok = np.array(_greedy_j(jl))
    jpp = jax.device_put(jp)
    for i in range(2):
        jl, jcache = js.decode_fn(jpp, jcache, tok, jnp.int32(4 + i), *jargs)
        tl, tcache = ts.decode_fn(tp, tcache, torch.from_numpy(tok), 4 + i,
                                  *targs)
        _assert_close(jl, tl, dtype, f"decode {i} logits")
        _assert_cache_close(jcache, tcache, dtype, f"decode {i} cache")
        tok = np.array(_greedy_j(jl))


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_7b"])
def test_bf16_prefill_of_the_recurrent_families(arch):
    """The reference's bfloat16 prefill raises (its scan carries float32
    recurrent leaves that a step turns bfloat16; ROADMAP §3); the port's
    loop runs and matches a Python loop of the reference's jitted
    ``decode_step``."""
    js, ts = _serve_both(arch, "bfloat16")
    jp, tp = _params(arch)
    prompt = _tokens(_cfgs(arch)[0].vocab, (B, 4), 6)
    with pytest.raises(TypeError, match="carry"):
        js.prefill_fn(jax.device_put(jp), js.init_cache(jnp.bfloat16),
                      prompt)
    step = _jdecode(arch, jnp.bfloat16)
    jcache = js.init_cache(jnp.bfloat16)
    for i in range(4):
        jl, jcache = step(jp, prompt[:, i:i + 1], jcache, i, None)
    tl, tcache = ts.prefill_fn(tp, ts.init_cache(torch.bfloat16),
                               torch.from_numpy(prompt))
    _assert_close(jl, tl, "bfloat16", "prefill logits")
    _assert_cache_close(jcache, tcache, "bfloat16", "prefill cache")


@pytest.mark.parametrize("arch", ["smollm_360m", "granite_moe_1b_a400m",
                                  "rwkv6_3b", "zamba2_7b"])
def test_prefill_matches_own_full_forward(arch):
    """The loop of decode steps against the port's full-sequence forward
    at the last position: the cache write path is consistent."""
    _, tc = _cfgs(arch)
    _, tp = _params(arch)
    ts = tserve.make_serve_step(tc, make_local_mesh(), B, 6,
                                compute_dtype=torch.float32,
                                cache_dtype=torch.float32, **CPU)
    prompt = torch.from_numpy(_tokens(tc.vocab, (B, 6), 2))
    pre, _ = ts.prefill_fn(tp, ts.init_cache(torch.float32), prompt)
    full, _, _ = transformer.forward(tp, tc, prompt,
                                     compute_dtype=torch.float32)
    np.testing.assert_allclose(pre[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=PREFILL_BAR, atol=PREFILL_BAR)


def test_publish_swap_changes_served_logits():
    """A published-params swap changes what decode_fn serves, and the
    published tree is bitwise (on one rank: the very tensors of) the tree
    that was handed over."""
    _, tc = _cfgs("smollm_360m")
    ts = tserve.make_serve_step(tc, make_local_mesh(), B, 4,
                                compute_dtype=torch.float32,
                                cache_dtype=torch.float32, **CPU)
    params_a = tmodel.init_params(tc, rng.PRNGKey(0, device="cpu"))
    params_b = tmodel.init_params(tc, rng.PRNGKey(1, device="cpu"))
    ref_b = [leaf.clone() for leaf in tree_leaves(params_b)]
    tok = torch.zeros((B, 1), dtype=torch.int32)
    view_a = ts.publish(params_a)
    logits_a, _ = ts.decode_fn(view_a, ts.init_cache(torch.float32), tok, 0)
    view_b = ts.publish(params_b)
    for got, src, want in zip(tree_leaves(view_b), tree_leaves(params_b),
                              ref_b):
        assert got is src and torch.equal(got, want)
    logits_b, _ = ts.decode_fn(view_b, ts.init_cache(torch.float32), tok, 0)
    assert not torch.equal(logits_a, logits_b)


# ---------------------------------------------------------------------------
# serve_while_train
# ---------------------------------------------------------------------------


def _record_logits(monkeypatch):
    """Wrap make_serve_step so that every prefill and decode records its
    logits, in call order."""
    seen = []
    make = tserve.make_serve_step

    def wrapped(*a, **kw):
        s = make(*a, **kw)
        pre, dec = s.prefill_fn, s.decode_fn

        def prefill(*args):
            out = pre(*args)
            seen.append(out[0])
            return out

        def decode(*args):
            out = dec(*args)
            seen.append(out[0])
            return out

        s.prefill_fn, s.decode_fn = prefill, decode
        return s

    monkeypatch.setattr(tserve, "make_serve_step", wrapped)
    return seen


_SWT = {}


def _swt(arch):
    """The reference's and the port's serve_while_train, once per arch;
    the port's logits of every served token."""
    if arch not in _SWT:
        jc, tc = _cfgs(arch)
        want = jfedllm.serve_while_train(
            jc, ota=JOTAConfig(**SWT_OTA),
            train_cfg=JTrainConfig(compute_dtype="float32"),
            mesh=_auto_mesh(), **SWT)
        with pytest.MonkeyPatch.context() as mp:
            seen = _record_logits(mp)
            got = fedllm.serve_while_train(
                tc, ota=OTAConfig(**SWT_OTA),
                train_cfg=TrainConfig(compute_dtype="float32"), **SWT,
                **CPU)
        _SWT[arch] = (want, got, seen)
    return _SWT[arch]


def _ties(want_tokens, got_tokens, logits):
    """Compare served tokens round by round and row by row up to the first
    difference; a difference must be a bfloat16 tie in the port's logits.
    Returns the number of (round, step) pairs that differ."""
    n_steps = want_tokens[0].shape[1]
    ties = set()
    for r, (w, g) in enumerate(zip(want_tokens, got_tokens)):
        for row in range(w.shape[0]):
            for i in range(n_steps):
                if w[row, i] == g[row, i]:
                    continue
                lg = logits[r * (n_steps + 1) + i][row, -1].float()
                top = float(lg[g[row, i]])
                # bfloat16 keeps 8 significant bits: its ulp at ``top``
                ulp = 2.0 ** (np.floor(np.log2(abs(top))) - 7)
                gap = top - float(lg[w[row, i]])
                assert 0 <= gap <= TIE_ULPS * ulp, (r, row, i, gap, ulp)
                ties.add((r, i))
                break
    return len(ties)


@pytest.mark.parametrize("arch", ["smollm_360m", "granite_moe_1b_a400m"])
def test_serve_while_train_matches_reference(arch):
    want, got, seen = _swt(arch)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert want["publish_bitwise"] and got["publish_bitwise"]
    assert len(got["served_tokens"]) == SWT["rounds"]
    assert [t.shape for t in got["served_tokens"]] == \
        [t.shape for t in want["served_tokens"]]
    # a prefill and decode_steps decodes a round
    assert len(seen) == SWT["rounds"] * (SWT["decode_steps"] + 1)
    assert _ties(want["served_tokens"], got["served_tokens"], seen) <= \
        MAX_TIES
    assert set(got["seconds"][0]) == {"train", "publish", "prefill",
                                      "decode"}


def test_serve_while_train_resume_is_bitwise(tmp_path):
    """A checkpoint after round 1, resumed for round 2: the loss, the
    served tokens and the params bitwise the straight run's."""
    _, tc = _cfgs("smollm_360m")
    _, straight, _ = _swt("smollm_360m")
    kw = dict(SWT, ota=OTAConfig(**SWT_OTA),
              train_cfg=TrainConfig(compute_dtype="float32"),
              checkpoint_dir=str(tmp_path), checkpoint_every=1, **CPU)
    first = fedllm.serve_while_train(tc, **dict(kw, rounds=1))
    assert os.path.exists(tmp_path / "fedllm_ckpt.npz")
    resumed = fedllm.serve_while_train(tc, resume=True, **kw)
    assert first["losses"][0] == straight["losses"][0]
    assert resumed["losses"].tolist() == straight["losses"][1:].tolist()
    np.testing.assert_array_equal(resumed["served_tokens"][0],
                                  straight["served_tokens"][1])
    for a, b in zip(tree_leaves(resumed["params"]),
                    tree_leaves(straight["params"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# bench_llm, serve_demo
# ---------------------------------------------------------------------------


def test_bench_llm_smoke_on_cpu(monkeypatch, tmp_path):
    """At ``SMOKE`` size with 256-entry projection blocks: the plain path
    draws each block matrix anew per AMP iteration, ~70 s a chunk of the
    smoke's 1024 x 4096 blocks on one CPU thread, ~0.1 s at 256."""
    monkeypatch.setattr(bench_llm, "SMOKE", True)
    monkeypatch.setattr(tbase, "ota_overrides", lambda arch: OTAConfig(
        projection="blocked", s_frac=0.25, k_frac=0.5, rademacher=True,
        block_size=256))
    out = tmp_path / "BENCH_torch_llm.json"
    with contextlib.redirect_stdout(io.StringIO()):
        doc = bench_llm.main(out_path=str(out), **CPU)
    assert json.loads(out.read_text()) == doc
    assert doc["smoke"] and doc["device"] == "cpu" and not doc["use_kernel"]
    assert doc["arch"] == "smollm_360m.reduced" and doc["rounds"] == 2
    for k in ("train_us_per_round", "serve_train_us_per_round",
              "compiled_cold_us_per_round", "rounds_per_sec",
              "tokens_per_sec_while_training"):
        assert doc[k] > 0, k
    with contextlib.redirect_stdout(io.StringIO()):
        assert check_regression.compare(doc, doc, strict=True) == 0
        ref = json.load(open(os.path.join(os.path.dirname(__file__), "..",
                                          "BENCH_llm.json")))
        # the reference's file and the port's share the gated keys
        assert set(check_regression.sweep_timings(ref)) == \
            set(check_regression.sweep_timings(doc))


def test_serve_demo_equals_reference(monkeypatch):
    """The port's demo prints the reference's sample rows (float32 greedy
    decoding of the reference's seeds)."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        runpy.run_path(os.path.join(os.path.dirname(__file__), "..",
                                    "examples", "serve_demo.py"))
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        seqs = serve_demo.main(**CPU)
    assert got.getvalue() == want.getvalue()
    assert all(tuple(s.shape) == (4, 32) for s in seqs.values())
