"""The projector's adjoint and the launch-per-op AMP decode, repro_torch
against repro.

The JAX side runs its Pallas adjoint (``ota_project_t_pallas``) in
interpret mode, as tests/test_kernels.py does; the port's side is the plain
version its CUDA kernel is held against on the card.  Inputs are made with
numpy from a seed and handed to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.amp import amp_decode_blocked as jax_amp_decode_blocked
from repro.core.projection import BlockedProjector as JaxBlockedProjector
from repro.kernels import ops as jops
from repro_torch.core.amp import amp_decode_blocked
from repro_torch.core.projection import BlockedProjector
from repro_torch.kernels import ops, ref

SHAPES = [  # (n_blocks, c, s_block), as tests/test_kernels.py
    (1, 128, 32),
    (3, 256, 64),
    (4, 512, 128),
    (2, 384, 96),
    (5, 64, 16),
]
TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("nb,c,sb", SHAPES)
@pytest.mark.parametrize("rademacher", [True, False])
def test_adjoint_matches_pallas_interpret(nb, c, sb, rademacher):
    y = np.random.default_rng(nb + 7).standard_normal((nb, sb)).astype(
        np.float32)
    want = jops.ota_project_t(jnp.asarray(y), seed=11, c=c,
                              rademacher=rademacher, use_kernel=True)
    got = ops.ota_project_t(torch.from_numpy(y), seed=11, c=c,
                            rademacher=rademacher, use_kernel=True)
    assert got.shape == (nb, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rademacher", [True, False])
def test_adjoint_identity(rademacher):
    """<A x, y> == <x, A^T y> for the generated operator, with a leading
    device axis."""
    m, nb, c, sb = 3, 3, 256, 64
    rs = np.random.default_rng(1)
    x = torch.from_numpy(rs.standard_normal((m, nb, c)).astype(np.float32))
    y = torch.from_numpy(rs.standard_normal((m, nb, sb)).astype(np.float32))
    ax = ops.ota_project(x, seed=5, s_block=sb, rademacher=rademacher,
                         use_kernel=True)
    aty = ops.ota_project_t(y, seed=5, c=c, rademacher=rademacher,
                            use_kernel=True)
    np.testing.assert_allclose(float((ax.double() * y.double()).sum()),
                               float((x.double() * aty.double()).sum()),
                               rtol=1e-4)


def test_projector_adjoint_matches_reference():
    """BlockedProjector.project_t with use_kernel, flat (d,) in and out,
    with a ragged last block."""
    d, c, sb = 1000, 128, 64
    jp = JaxBlockedProjector(d=d, block_size=c, s_block=sb, seed=3,
                             use_kernel=True)
    tp = BlockedProjector(d=d, block_size=c, s_block=sb, seed=3,
                          use_kernel=True)
    y = np.random.default_rng(2).standard_normal(tp.out_dim).astype(
        np.float32)
    got = tp.project_t(torch.from_numpy(y))
    assert got.shape == (d,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jp.project_t(y)), **TOL)


def _noisy_block_sparse(nb, c, sb, seed, proj_seed):
    rs = np.random.default_rng(seed)
    x = np.zeros((nb, c), np.float32)
    for b in range(nb):
        idx = rs.choice(c, sb // 8, replace=False)
        x[b, idx] = rs.standard_normal(sb // 8)
    yb = ref.ota_project_ref(torch.from_numpy(x), proj_seed, sb).numpy()
    return x, (yb + 0.01 * rs.standard_normal(yb.shape)).astype(np.float32)


@pytest.mark.parametrize("rademacher", [True, False])
def test_unfused_decode_matches_reference(rademacher):
    """amp_decode_blocked on use_kernel projectors, d = 1024, c = 128,
    s = 64, 5 iterations: the port against the JAX package."""
    d, c, sb, iters = 1024, 128, 64, 5
    kw = dict(d=d, block_size=c, s_block=sb, seed=9, rademacher=rademacher,
              use_kernel=True)
    _, yb = _noisy_block_sparse(d // c, c, sb, 4, 9)
    want = jax_amp_decode_blocked(jnp.asarray(yb), JaxBlockedProjector(**kw),
                                  iters=iters)
    got = amp_decode_blocked(torch.from_numpy(yb), BlockedProjector(**kw),
                             iters=iters)
    assert got.shape == (d,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
