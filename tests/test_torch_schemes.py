"""repro_torch.core.schemes.round_simulated against repro.core.schemes."""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import schemes as js
from repro_torch import rng
from repro_torch.configs.base import OTAConfig as TorchOTAConfig
from repro_torch.core import schemes as ts

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tests.golden.parity_cases import PARITY_CASES  # noqa: E402

M, D = 4, 256
CASES = {
    "ideal": PARITY_CASES["ideal"],
    "a_dsgd_dense": PARITY_CASES["a_dsgd_dense"],
    "a_dsgd_blocked": PARITY_CASES["a_dsgd_blocked"],
    "a_dsgd_blocked_kernel": dataclasses.replace(
        PARITY_CASES["a_dsgd_blocked"], use_kernel=True),
    "a_dsgd_blocked_rademacher_kernel": dataclasses.replace(
        PARITY_CASES["a_dsgd_blocked"], use_kernel=True, rademacher=True),
}


def _port_cfg(cfg):
    return TorchOTAConfig(**dataclasses.asdict(cfg))


def _grads():
    rs = np.random.default_rng(7)
    base = rs.standard_normal(D).astype(np.float32)
    grads = base[None] + 0.1 * rs.standard_normal((M, D)).astype(np.float32)
    deltas = 0.05 * rs.standard_normal((M, D)).astype(np.float32)
    return grads, deltas


@pytest.fixture(scope="module")
def rounds():
    """Both packages' round at step 0 and step 5 (mean removal on, off)."""
    grads, deltas = _grads()
    out = {}
    for name, cfg in CASES.items():
        sj = js.get_scheme(cfg, D, M)
        st = ts.get_scheme(_port_cfg(cfg), D, M, device="cpu")
        for step in (0, 5):
            gj, dj, mj = js.round_simulated(sj, grads, deltas, step,
                                            jax.random.PRNGKey(11))
            gt, dt, mt = ts.round_simulated(st, torch.from_numpy(grads),
                                            torch.from_numpy(deltas), step,
                                            rng.PRNGKey(11))
            out[name, step] = ((np.asarray(gj), np.asarray(dj),
                                {k: float(v) for k, v in mj.items()}),
                               (gt.numpy(), dt.numpy(),
                                {k: float(v) for k, v in mt.items()}))
    return out


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("step", [0, 5])
def test_round_ghat_and_deltas(rounds, name, step):
    (gj, dj, _), (gt, dt, _) = rounds[name, step]
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_round_metrics(rounds, name):
    for step in (0, 5):
        (_, _, mj), (_, _, mt) = rounds[name, step]
        assert set(mt) == set(mj)
        for k in ("alpha", "p_t", "frame_power", "active_frac"):
            if k in mj:
                np.testing.assert_allclose(mt[k], mj[k], rtol=1e-5)


def test_unported_axes_raise_at_construction():
    for kw in (dict(fading="rayleigh", scheme="a_dsgd_fading"),
               dict(geometry="disk"), dict(robust=True),
               dict(scheduler="round_robin"), dict(local="fedavg")):
        with pytest.raises(NotImplementedError):
            ts.get_scheme(TorchOTAConfig(**kw), D, M, device="cpu")
    for name in ("d_dsgd", "signsgd", "qsgd"):
        with pytest.raises(NotImplementedError):
            ts.get_scheme(TorchOTAConfig(scheme=name), D, M, device="cpu")


def test_channel_dim_and_k_match_reference():
    for name in ("a_dsgd_dense", "a_dsgd_blocked"):
        sj = js.get_scheme(CASES[name], 1234, 25)
        st = ts.get_scheme(_port_cfg(CASES[name]), 1234, 25, device="cpu")
        assert st.channel_dim() == sj.channel_dim()
        assert st.k == sj.k
