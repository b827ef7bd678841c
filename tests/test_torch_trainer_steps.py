"""Whole steps of the sharded trainer, repro_torch against repro: three
steps of flat A-DSGD, the ideal link, the sliced layout and two edge-site
groups on a 4 x 2 mesh, and the ideal step against one device.

The reference runs on an Auto 4 x 2 mesh of forced host devices in one
subprocess for the module (``tests/torch_trainer_ref.py``, part
``steps``): smollm-360m reduced in float32, the settings of the
reference's own ``tests/test_distributed.py``, the batch
``randint(PRNGKey(1), (8, 32))`` every step and the keys ``PRNGKey(step)``.

Bars, each measured on these inputs:

* ``global_loss``, ``loss`` and ``ppl`` per step within 1e-5 relative
  (measured at most 2.6e-6, ``global_loss`` of the grouped run's step 2);
  every metric of step 0 within 1e-5 relative;
  after step 0 the frame's ``alpha``, ``tau`` and ``frame_power`` within
  1e-3 (measured up to 1.9e-4, ``tau`` of the grouped run's step 2): the
  params part by Adam's steps where a ĝ entry moved by an ulp (below), and
  the threshold and the frame's scale follow the params;
* params after 3 steps within lr x steps = 3e-3 of the reference's, at
  most ``PARAM_FLIPS`` = 400 entries past 1e-4 (an entry whose ĝ moved
  moves by Adam's step, at most lr a step; measured: flat A-DSGD 148, at
  most 2.2e-3; sliced 24, 7.5e-4; two groups 116, 1.3e-3; ideal 0,
  5.5e-5);
* the ideal step on 4 x 2 against the port's own one-device gradient and
  Adam step on the whole batch at rtol 2e-3 / atol 5e-4, the bar of the
  reference's ``test_ideal_distributed_matches_single_device``.
"""
import numpy as np
import pytest
import torch

import torch_trainer_ref as R
from repro_torch import rng
from repro_torch.configs.base import OTAConfig, TrainConfig, get_config
from repro_torch.convert import ravel, tree_leaves, tree_map
from repro_torch.models import model as tmodel
from repro_torch.optim.optim import make_optimizer
from repro_torch.sharding import Mesh
from repro_torch.train import trainer as T

CPU = dict(device="cpu")
LOSS_RTOL = 1e-5
METRIC_RTOL, FRAME_RTOL = 1e-5, 1e-3
PARAM_ATOL = 1e-4
#: entries of the params past PARAM_ATOL after 3 steps, and the bar on
#: each: lr x steps
PARAM_FLIPS = {"adsgd": 400, "ideal": 0, "sliced": 400, "groups": 400}
PARAM_FLIP_ATOL = R.TRAIN["lr"] * R.STEPS


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    """The reference, started before the module's first test: the tests
    compute the port's side before they read it."""
    ref = R.Reference(tmp_path_factory.mktemp("ref") / "steps.npz",
                      "steps")
    yield ref
    ref.close()


def _arch():
    return get_config(R.ARCH).reduced()


def _step(over, sliced=False, donate=False):
    mk = T.make_train_step_sliced if sliced else T.make_train_step
    return mk(_arch(), TrainConfig(**R.TRAIN),
              OTAConfig(**{**R.OTA, **over}), Mesh(*R.MESH_4X2),
              ota_axes=("data",), donate=donate, **CPU)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _run(ts, tokens, steps=R.STEPS):
    params, opt_state, delta = ts.init_state(rng.PRNGKey(0))
    fn = ts.jitted({"tokens": tokens})
    mets = []
    for step in range(steps):
        params, opt_state, delta, met = fn(
            params, opt_state, delta, {"tokens": tokens}, step,
            rng.PRNGKey(step))
        mets.append(met)
    return params, opt_state, delta, mets


@pytest.mark.parametrize("case", list(R.STEP_CASES))
def test_steps_match_reference(ref, case):
    over, sliced = R.STEP_CASES[case]
    tokens = R.batch_tokens()
    params, _, delta, mets = _run(_step(over, sliced), tokens)
    np.testing.assert_array_equal(tokens, ref["tokens"])
    for step, met in enumerate(mets):
        want = {k.split("/")[-1]: ref[k] for k in ref
                if k.startswith(f"step/{case}/{step}/")}
        assert set(met) == set(want), step
        for k, w in want.items():
            bar = (FRAME_RTOL if step and k in ("alpha", "tau",
                                                "frame_power")
                   else LOSS_RTOL if k == "global_loss" else METRIC_RTOL)
            assert _rel(met[k], w) <= bar, (step, k, float(met[k]),
                                            float(w))
    got = ravel(params).numpy()
    want = ref[f"step/{case}/params"]
    diff = np.abs(got - want)
    assert (diff > PARAM_ATOL).sum() <= PARAM_FLIPS[case], \
        (diff > PARAM_ATOL).sum()
    assert diff.max() <= PARAM_FLIP_ATOL, diff.max()
    for i, leaf in enumerate(tree_leaves(delta)):
        assert tuple(leaf.shape) == ref[f"step/{case}/delta/{i}"].shape
    if case == "adsgd":
        # the reference's own test_adsgd_distributed_loss_decreases: the
        # loss falls, the error feedback engaged, the frame power is P_t
        losses = [float(m["global_loss"]) for m in mets]
        assert losses[-1] < losses[0], losses
        assert float(delta.abs().sum()) > 0
        assert abs(float(mets[-1]["frame_power"]) - R.OTA["p_avg"]) < 5.0


def test_ideal_equals_one_device():
    """psum / M over 4 x 2 == one device's gradient on the whole batch."""
    tokens = R.batch_tokens()
    ts = _step({"scheme": "ideal"})
    params, opt_state, delta = ts.init_state(rng.PRNGKey(0))
    p1, _, _, _ = ts.jitted({"tokens": tokens})(
        params, opt_state, delta, {"tokens": tokens}, 0, rng.PRNGKey(0))
    p = tree_map(lambda a: a.detach().requires_grad_(True), params)
    loss, _ = tmodel.loss_fn(p, _arch(),
                             {"tokens": torch.from_numpy(tokens.copy())},
                             compute_dtype=torch.float32, remat=True,
                             loss_chunk=2048)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), _sorted(params))
    opt = make_optimizer(TrainConfig(**R.TRAIN))
    p_ref, _ = opt.apply(params, gtree, opt.init(params))
    for a, b in zip(tree_leaves(p1), tree_leaves(p_ref)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=2e-3,
                                   atol=5e-4)


def _sorted(tree):
    """The tree with its keys in sorted order at every level (the order
    ``tree_leaves`` walks)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def test_donated_step_equals_the_undonated():
    """``donate`` writes the new error state over the input's storage and
    changes no result (the ideal link and two sliced sub-frames)."""
    tokens = R.batch_tokens()
    for over, sliced in (({"scheme": "ideal"}, False),
                         ({"scheme": "ideal", "layout": "sliced"}, True)):
        outs = []
        for donate in (False, True):
            ts = _step(over, sliced, donate)
            params, opt_state, delta = ts.init_state(rng.PRNGKey(0))
            fn = ts.jitted({"tokens": tokens})
            for step in range(2):
                new = fn(params, opt_state, delta, {"tokens": tokens}, step,
                         rng.PRNGKey(step))
                assert (new[2] is delta) == donate
                params, opt_state, delta, met = new
            outs.append((ravel(params), met))
        assert torch.equal(outs[0][0], outs[1][0])
        assert {k: float(v) for k, v in outs[0][1].items()} == \
            {k: float(v) for k, v in outs[1][1].items()}


def test_split_times_the_three_phases():
    ts = _step({"scheme": "ideal"})
    params, opt_state, delta = ts.init_state(rng.PRNGKey(0))
    ts.step_fn(params, opt_state, delta, {"tokens": R.batch_tokens()}, 0,
               rng.PRNGKey(0))
    assert set(ts.split) == {"grads", "aggregate", "update"}
    assert all(v >= 0 for v in ts.split.values())
