"""The sharded trainer's pieces, repro_torch against repro: ``TokenStream``,
the step's layouts and spec trees, ``init_state``, phase 1 (the OTA
devices' gradients) and phase 2 (the aggregation on slices) apart, and
``make_serve_step`` on a 2 x 2 mesh.

The reference runs on Auto meshes of 8 forced host devices in one
subprocess for the module (``tests/torch_trainer_ref.py``, part
``phases``); the port runs on a mesh of rank threads on the CPU.  Whole
steps are in ``tests/test_torch_trainer_steps.py``.

Bars, each measured on these inputs:

* ``TokenStream.batch_at``, the layouts, the spec trees, the state's
  shapes and dtypes and the initial params: equal;
* phase 1: the gradient stack within rtol 1e-4 / atol 1e-6 (the gradient
  bar of ``tests/test_torch_models.py``; measured: 97 % of the entries
  differ by ulps, at most 2.8e-7, 1.2e-6 of the stack's largest
  magnitude: GSPMD's reduction order under ``'model' = 2`` against the
  port's whole-model products), ``global_loss`` within 1e-6 relative
  (measured 7.6e-8), ``loss``, ``ppl`` and ``aux`` OTA rank 0's within
  1e-6 relative (measured equal);
* phase 2 from the reference's gradient stack (the bars of
  ``tests/test_torch_distributed.py``): the ideal ĝ and error state
  bitwise; an analog ĝ within rtol 1e-4 / atol 1e-5 but for at most
  ``FLIP_COUNT`` = 64 entries in one AMP block, each within ``FLIP_ATOL``
  = 5e-3 (``tests/test_torch_fedllm.py``'s bar: the port's plain AMP sums
  in float64 and rounds once, the reference's in float32, and a block's
  iterates can part; measured: ``shard_decode``, 16 entries of block
  2353, up to 1.7e-3, the support the same; the other cases none); the
  error state bitwise (the threshold and the kept entries are); the
  metrics within 1e-5 relative;
* the serve step on 2 x 2 in float32: logits within 1e-5 of their largest
  magnitude (``test_decode_step_matches_reference``'s bar).
"""
import json

import jax
import numpy as np
import pytest
import torch

import torch_trainer_ref as R
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models import model as jmodel
from repro_torch import rng
from repro_torch import sharding
from repro_torch.configs.base import OTAConfig, TrainConfig, get_config
from repro_torch.convert import ravel, tree_leaves, unravel
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.sharding import Mesh, P
from repro_torch.sharding.specs import NamedSharding
from repro_torch.train import serve as tserve
from repro_torch.train import trainer as T

CPU = dict(device="cpu")
GRAD = dict(rtol=1e-4, atol=1e-6)
ANALOG = dict(rtol=1e-4, atol=1e-5)
FLIP_COUNT, FLIP_ATOL = 64, 5e-3
METRIC_RTOL = 1e-5
LOSS_RTOL = 1e-6
F32_BAR = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module on two intra-op threads (the rank threads run one at a
    time; a parallel run's busy cores slow a larger pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    """The reference, started before the module's first test: the tests
    compute the port's side before they read it."""
    ref = R.Reference(tmp_path_factory.mktemp("ref") / "phases.npz",
                      "phases")
    yield ref
    ref.close()


def _arch():
    return get_config(R.ARCH).reduced()


def _ota(**over):
    return OTAConfig(**{**R.OTA, **over})


def _step(over, shape=R.MESH_4X2, axes=("data",), sliced=False):
    mk = T.make_train_step_sliced if sliced else T.make_train_step
    return mk(_arch(), TrainConfig(**R.TRAIN), _ota(**over), Mesh(*shape),
              ota_axes=axes, donate=False, **CPU)


def _bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.astype(np.float32).view(np.int32))


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# ---------------------------------------------------------------------------
# TokenStream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("vocab", [512, 49152])
def test_token_stream_bitwise(vocab, n_shards):
    got = TokenStream(vocab, seq_len=17, batch=8, seed=3)
    want = JTokenStream(vocab, seq_len=17, batch=8, seed=3)
    for step in (0, 1, 7):
        for shard in range(n_shards):
            g = got.batch_at(step, shard, n_shards)["tokens"]
            w = want.batch_at(step, shard, n_shards)["tokens"]
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_token_stream_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        TokenStream(512, seq_len=4, batch=6).batch_at(0, 0, 4)


# ---------------------------------------------------------------------------
# layouts, specs, init_state
# ---------------------------------------------------------------------------


def _spec(s):
    s = s.spec if isinstance(s, NamedSharding) else s
    return [list(e) if isinstance(e, tuple) else e for e in s]


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}['{k}']"))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}[{i}]"))
        return out
    return {path: tree}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_init_state_equals_reference(state_dtype):
    ts = _step({"state_dtype": state_dtype})
    params, opt_state, delta = ts.init_state(rng.PRNGKey(0))
    jparams = jax.device_get(jmodel.init_params(
        R.arch(), jax.random.PRNGKey(0)))
    jflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tflat = _flat(params)
    assert sorted(jflat) == sorted(tflat)
    for k, w in jflat.items():
        _bits(tflat[k], np.asarray(w))
    assert set(opt_state) == {"m", "v", "count"}
    assert opt_state["count"].dtype == torch.int32
    assert int(opt_state["count"]) == 0
    for leaf in tree_leaves(opt_state["m"]) + tree_leaves(opt_state["v"]):
        assert leaf.dtype == torch.float32 and not leaf.any()
    assert delta.dtype == getattr(torch, state_dtype)
    assert tuple(delta.shape) == ts.delta_shape and not delta.any()


def test_sliced_init_state_and_make_train_step_ignores_layout():
    """The sliced step's delta is the two sub-frames' pair; the flat
    builder, like the reference's, ignores ``ota.layout``."""
    ts = _step({"layout": "sliced"}, sliced=True)
    _, _, delta = ts.init_state(rng.PRNGKey(0))
    assert sorted(delta) == ["rep", "sh"]
    assert tuple(delta["sh"].shape) == ts.delta_shape[0]
    assert tuple(delta["rep"].shape) == ts.delta_shape[1]
    flat = _step({"layout": "sliced"})
    assert isinstance(flat.delta_shape[0], int)


def test_sliced_layout_needs_model_as_the_only_other_axis():
    with pytest.raises(ValueError, match="all but the model axis"):
        _step({}, R.MESH_2X2X2, ("pod",), sliced=True)


def test_process_group_mesh_raises_naming_the_item():
    mesh = Mesh((4, 2), ("data", "model"), device_mesh=object())
    with pytest.raises(NotImplementedError, match="item 6"):
        T.make_train_step(_arch(), TrainConfig(**R.TRAIN), _ota(), mesh,
                          **CPU)


def test_entry_points_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.make_train_step(_arch(), TrainConfig(**R.TRAIN), _ota(),
                          Mesh(*R.MESH_4X2))


def test_jitted_caches_by_the_batch_keys():
    ts = _step({"scheme": "ideal"})
    a = ts.jitted({"tokens": None})
    assert ts.jitted({"tokens": 1}) is a
    assert set(ts._jit_cache) == {("tokens",)}


def test_phase1_loss_is_rank_zeros_and_global_the_mean():
    """``loss`` is OTA rank 0's local loss; ``global_loss`` the mean over
    the ranks' local losses, summed in rank order."""
    from repro_torch.models import model as tmodel
    ts = _step({"scheme": "ideal"})
    params, _, _ = ts.init_state(rng.PRNGKey(0))
    tokens = R.batch_tokens()
    _, met = ts.grads_fn(params, {"tokens": tokens})
    with torch.no_grad():
        local = [tmodel.loss_fn(params, _arch(),
                                {"tokens": torch.from_numpy(t.copy())},
                                compute_dtype=torch.float32)[0]
                 for t in np.split(tokens, 4)]
    acc = local[0]
    for x in local[1:]:
        acc = acc + x
    assert float(met["loss"]) == float(local[0])
    assert float(met["global_loss"]) == float(acc * 0.25)


def test_thread_mesh_collectives_reset_after_a_step():
    """A step leaves no rank bound to the calling thread."""
    ts = _step({"scheme": "ideal"})
    params, opt_state, delta = ts.init_state(rng.PRNGKey(0))
    ts.step_fn(params, opt_state, delta, {"tokens": R.batch_tokens()}, 0,
               rng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="outside shard_map"):
        sharding.axis_index("data")


@pytest.mark.parametrize("case", list(R.LAYOUT_CASES))
def test_layout_and_specs_equal_reference(ref, case):
    shape, over, axes, sliced = R.LAYOUT_CASES[case]
    ts = _step(over, shape, axes, sliced)
    state = ts.init_state(rng.PRNGKey(0))
    want = json.loads(str(ref["layout/json"]))[case]
    assert (ts.d, ts.d_pad, ts.m_devices) == (want["d"], want["d_pad"],
                                              want["m_devices"])
    assert json.loads(json.dumps(ts.delta_shape)) == want["delta_shape"]
    assert _spec(ts.batch_spec) == want["batch_spec"]
    for name in ("param_sharding", "opt_sharding", "delta_sharding"):
        got = {k: _spec(v) for k, v in _flat(getattr(ts, name)).items()}
        assert got == want[name], name
        assert all(v.mesh is ts.mesh
                   for v in _flat(getattr(ts, name)).values())
    # init_state: every leaf's shape and dtype
    got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
           for k, v in _flat(state).items()}
    assert got == want["state"]


# ---------------------------------------------------------------------------
# phase 1 and phase 2
# ---------------------------------------------------------------------------


def test_phase1_matches_reference(ref):
    ts = _step({})
    params, _, _ = ts.init_state(rng.PRNGKey(0))
    tokens = R.batch_tokens()
    gstack, met = ts.grads_fn(params, {"tokens": tokens})
    np.testing.assert_array_equal(tokens, ref["tokens"])
    want = ref["phase1/grads"]
    got = gstack.numpy()
    assert got.shape == want.shape == (4, ts.d_pad)
    assert not got[:, ts.d:].any()
    np.testing.assert_allclose(got, want, **GRAD)
    assert _rel(met["global_loss"], ref["phase1/global_loss"]) <= LOSS_RTOL
    for k in ("loss", "ppl", "aux"):
        assert abs(float(met[k]) - float(ref[f"phase1/{k}"])) <= \
            LOSS_RTOL * max(abs(float(ref[f"phase1/{k}"])), 1.0), k


def _analog_close(got, want, c):
    """Within the AMP bar but for at most ``FLIP_COUNT`` entries in one
    block of ``c``, each within ``FLIP_ATOL``."""
    off = np.abs(got - want) > ANALOG["atol"] + ANALOG["rtol"] * np.abs(want)
    blocks = np.unique(np.nonzero(off)[0] // c)
    assert off.sum() <= FLIP_COUNT and len(blocks) <= 1, (off.sum(), blocks)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLIP_ATOL)


def _agg_inputs(ref, ts, case):
    """The reference's phase-1 stack and input delta at the case's
    layout, as the port's tensors."""
    g = ref["phase1/grads"]
    over, sliced = R.AGG_CASES[case]
    if not sliced:
        return torch.from_numpy(g.copy()), torch.from_numpy(
            ref["phase2/delta"].copy())
    aparams = T.abstract_params(_arch())
    rows = [tree_leaves(unravel(torch.from_numpy(g[i, :ts.d].copy()),
                                aparams)) for i in range(4)]
    gstack = [torch.stack(leaves) for leaves in zip(*rows)]
    delta = {"sh": torch.from_numpy(ref[f"phase2/{case}/delta_sh_in"]),
             "rep": torch.from_numpy(ref[f"phase2/{case}/delta_rep_in"])}
    return gstack, delta


@pytest.mark.parametrize("case", list(R.AGG_CASES))
def test_phase2_matches_reference(ref, case):
    over, sliced = R.AGG_CASES[case]
    ts = _step(over, sliced=sliced)
    gstack, delta = _agg_inputs(ref, ts, case)
    # the grouped case writes the new state over its input, as a donated
    # step does; the others into a fresh tensor
    out = (delta if case == "groups" else
           {k: torch.empty_like(v) for k, v in delta.items()} if sliced
           else torch.empty_like(delta))
    ghat, met = ts.aggregate_fn(gstack, delta, R.AGG_STEP,
                                rng.PRNGKey(R.AGG_KEY), out)
    got = ravel(ghat).numpy()
    want = ref[f"phase2/{case}/ghat"]
    if sliced:
        _bits(out["sh"], ref[f"phase2/{case}/delta_sh"])
        _bits(out["rep"], ref[f"phase2/{case}/delta_rep"])
    else:
        want = want[:ts.d]
        _bits(out, ref[f"phase2/{case}/delta"])
    assert (out is delta) == (case == "groups")
    if over.get("scheme") == "ideal":
        _bits(got, want)
    else:
        _analog_close(got, want, ts.ota.block_size)
    keys = {k.split("/")[-1] for k in ref
            if k.startswith(f"phase2/{case}/")} - {
        "ghat", "delta", "delta_sh", "delta_rep", "delta_sh_in",
        "delta_rep_in"}
    assert keys == set(met)
    for k in keys:
        assert _rel(met[k], ref[f"phase2/{case}/{k}"]) <= METRIC_RTOL, k


# ---------------------------------------------------------------------------
# the serve step on a mesh of 2 x 2 ranks
# ---------------------------------------------------------------------------


def test_serve_step_on_2x2_matches_reference(ref):
    arch = _arch()
    n = R.SERVE_PROMPT + R.SERVE_STEPS
    ss = tserve.make_serve_step(arch, make_local_mesh(2, 2), R.SERVE_B, n,
                                compute_dtype=torch.float32,
                                cache_dtype=torch.float32, **CPU)
    specs = json.loads(str(ref["serve/specs"]))
    for name in ("param_sharding", "cache_sharding"):
        got = {k: _spec(v) for k, v in _flat(getattr(ss, name)).items()}
        assert got == specs[name], name
    params = ss.publish(_step({"scheme": "ideal"}).init_state(
        rng.PRNGKey(0))[0])
    logits, cache = ss.prefill_fn(params, ss.init_cache(torch.float32),
                                  torch.from_numpy(ref["serve/prompt"]))
    for i in range(R.SERVE_STEPS + 1):
        want = ref[f"serve/logits/{i}"]
        got = logits.numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= F32_BAR * np.abs(want).max(), i
        if i == R.SERVE_STEPS:
            break
        tok = torch.from_numpy(want[:, -1, :].argmax(-1)[:, None].astype(
            np.int32))
        logits, cache = ss.decode_fn(params, cache, tok, R.SERVE_PROMPT + i)
