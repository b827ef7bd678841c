"""The six channel parity cases of ``tests/golden/parity_cases.py`` and the
two checks each runs against the live reference, shared by
``tests/test_torch_channel_dense.py`` and ``tests/test_torch_channel_blocked.py``
(one file per projector, so that a parallel run spreads them) and used by
``tests/test_torch_channel.py``."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schemes as jsc
from repro.experiments import engine as jeng
from repro_torch import rng
from repro_torch.configs.base import OTAConfig
from repro_torch.core import schemes as tsc
from repro_torch.data import federated_split, make_classification
from repro_torch.experiments import engine
from repro_torch.train import paper_repro as tpr

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tests.golden.parity_cases import PARITY_CASES  # noqa: E402

CPU = dict(device="cpu")
STEPS, EVERY, M, B, D = 10, 2, 4, 64, 256

CHANNEL_CASES = ("a_dsgd_rayleigh", "a_dsgd_csi_err0", "a_dsgd_csi_err",
                 "a_dsgd_blind", "a_dsgd_gauss_markov", "a_dsgd_geometry")


def case(name, projection):
    """A parity case on the dense projector, or on the blocked one."""
    cfg = PARITY_CASES[name]
    if projection == "blocked":
        cfg = dataclasses.replace(cfg, projection="blocked", block_size=64)
    return cfg


def port(cfg):
    return OTAConfig(**dataclasses.asdict(cfg))


def make_data():
    """M = 4 devices of B = 64 samples, dim 48 (tests/test_experiments.py)."""
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=800, n_test=300, dim=48, noise=2.0, seed=3)
    xd, yd = federated_split(xtr, ytr, m=M, b=B, iid=True, seed=0)
    return xd, yd, xte, yte


def compiled(data, cfg, steps=STEPS, **kw):
    return engine.run_compiled(*data, port(cfg), steps=steps, lr=1e-3,
                               eval_every=EVERY, **CPU, **kw)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread, restored after it: these runs are
    thousands of small ops, which a parallel test run's busy cores slow far
    more with a pool of threads to wake than without.  Every comparison in
    a test runs under the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_rounds(name, projection):
    """Ten rounds of ``round_simulated`` (the reference under ``jit``, its
    round key and step traced), each device's gradient drawn anew from a
    seed and each package carrying its own error state: ĝ within rtol 1e-4
    / atol 1e-5 per round, and the channel metrics within 1e-5."""
    cfg = case(name, projection)
    sj = jsc.get_scheme(cfg, D, M)
    st = tsc.get_scheme(port(cfg), D, M, **CPU)
    ref = jax.jit(lambda g, dl, s, k: jsc.round_simulated(sj, g, dl, s, k))
    rs = np.random.default_rng(7)
    dj = np.zeros((M, D), np.float32)
    dt = torch.zeros((M, D))
    for t in range(STEPS):
        base = rs.standard_normal(D).astype(np.float32)
        grads = base[None] + 0.1 * rs.standard_normal((M, D)).astype(
            np.float32)
        gj, dj, mj = ref(grads, dj, jnp.int32(t),
                         jax.random.PRNGKey(1000 + t))
        gt, dt, mt = tsc.round_simulated(st, torch.from_numpy(grads), dt, t,
                                         rng.PRNGKey(1000 + t))
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4, atol=1e-5,
                                   err_msg=f"round {t}")
        assert set(mt) == set(mj)
        for k in ("active_frac", "chan_gain", "noise_scale"):
            if k in mj:
                np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                           rtol=1e-5, err_msg=k)


def check_runs(data, name, projection):
    """``run_compiled`` equals the port's ``run_federated`` entry for entry,
    and its test losses are within 1e-5 of the JAX engine's."""
    cfg = case(name, projection)
    got = compiled(data, cfg)
    loop = tpr.run_federated(*data, port(cfg), steps=STEPS, lr=1e-3,
                             eval_every=EVERY, **CPU)
    assert got.accs == loop.accs
    assert got.losses == loop.losses
    assert got.metrics == loop.metrics
    want = jeng.run_compiled(*data, cfg, steps=STEPS, lr=1e-3,
                             eval_every=EVERY)
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=0,
                               atol=1e-5)
