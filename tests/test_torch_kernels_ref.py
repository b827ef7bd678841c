"""repro_torch.kernels.ref (the kernels' plain versions) against repro.kernels.ref."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

SHAPES = [  # (n_blocks, c, s_block), as tests/test_kernels.py
    (1, 128, 32),
    (3, 256, 64),
    (4, 512, 128),
    (2, 384, 96),
    (5, 64, 16),
]


def test_hash3_bitwise():
    rs = np.random.default_rng(0)
    seed, blk, row, col = (rs.integers(0, 2**32, 4096, dtype=np.uint64)
                           .astype(np.uint32) for _ in range(4))
    hj = np.asarray(jref.hash3(jnp.asarray(seed), blk, row, col))
    ht = tref.hash3(*(torch.from_numpy(a.astype(np.int64))
                      for a in (seed, blk, row, col)))
    np.testing.assert_array_equal(hj.astype(np.int64), ht.numpy())
    np.testing.assert_array_equal(
        np.asarray(jref.splitmix32(jnp.asarray(seed))).astype(np.int64),
        tref.splitmix32(torch.from_numpy(seed.astype(np.int64))).numpy())


@pytest.mark.parametrize("seed,block", [(0, 3), (11, 0), (2**32 - 1, 7)])
def test_block_matrix_rademacher_bitwise(seed, block):
    aj = np.asarray(jref.block_matrix_ref(seed, jnp.uint32(block), 64, 96))
    at = tref.block_matrix_ref(seed, block, 64, 96).numpy()
    np.testing.assert_array_equal(aj, at)


@pytest.mark.parametrize("seed,block", [(0, 3), (11, 0), (2**32 - 1, 7)])
def test_block_matrix_gaussian(seed, block):
    """Box-Muller through float32 log/cos: XLA's and torch's differ in the
    last bits, so 1e-6."""
    aj = np.asarray(jref.block_matrix_ref(seed, jnp.uint32(block), 64, 96,
                                          rademacher=False))
    at = tref.block_matrix_ref(seed, block, 64, 96, rademacher=False).numpy()
    np.testing.assert_allclose(at, aj, rtol=1e-6, atol=1e-6)


def test_block_matrix_batched_ids():
    ids = torch.tensor([4, 0, 9])
    a = tref.block_matrix_ref(5, ids, 16, 32)
    for i, b in enumerate(ids.tolist()):
        np.testing.assert_array_equal(a[i].numpy(),
                                      tref.block_matrix_ref(5, b, 16, 32).numpy())


@pytest.mark.parametrize("n", [1024, 999, 10007])
def test_ef_sparsify_ref_bitwise(n):
    rs = np.random.default_rng(n)
    g = rs.standard_normal(n).astype(np.float32)
    d = rs.standard_normal(n).astype(np.float32)
    tau = np.float32(0.7)
    sj, dj = jref.ef_sparsify_ref(jnp.asarray(g), jnp.asarray(d), tau)
    st, dt = tref.ef_sparsify_ref(torch.from_numpy(g), torch.from_numpy(d),
                                  torch.tensor(tau))
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())


def test_ef_sparsify_ref_per_row_threshold():
    rs = np.random.default_rng(1)
    g = rs.standard_normal((4, 333)).astype(np.float32)
    d = rs.standard_normal((4, 333)).astype(np.float32)
    tau = np.float32([0.1, 0.5, 1.0, 2.0])
    st, dt = tref.ef_sparsify_ref(torch.from_numpy(g), torch.from_numpy(d),
                                  torch.from_numpy(tau))
    for i in range(4):
        sj, dj = jref.ef_sparsify_ref(jnp.asarray(g[i]), jnp.asarray(d[i]),
                                      tau[i])
        np.testing.assert_array_equal(np.asarray(sj), st[i].numpy())
        np.testing.assert_array_equal(np.asarray(dj), dt[i].numpy())


@pytest.mark.parametrize("nb,c,sb", SHAPES)
@pytest.mark.parametrize("rademacher", [True, False])
def test_ota_project_ref(nb, c, sb, rademacher):
    rs = np.random.default_rng(nb * c)
    x = rs.standard_normal((nb, c)).astype(np.float32)
    y = rs.standard_normal((nb, sb)).astype(np.float32)
    pj = np.asarray(jref.ota_project_ref(jnp.asarray(x), 11, sb, rademacher))
    pt = tref.ota_project_ref(torch.from_numpy(x), 11, sb, rademacher)
    np.testing.assert_allclose(pt.numpy(), pj, rtol=3e-5, atol=3e-5)
    tj = np.asarray(jref.ota_project_t_ref(jnp.asarray(y), 11, c, rademacher))
    tt = tref.ota_project_t_ref(torch.from_numpy(y), 11, c, rademacher)
    np.testing.assert_allclose(tt.numpy(), tj, rtol=3e-5, atol=3e-5)


def test_ota_project_ref_device_axis():
    """A leading device axis is M independent projections with one A."""
    rs = np.random.default_rng(2)
    x = torch.from_numpy(rs.standard_normal((3, 2, 64)).astype(np.float32))
    y = tref.ota_project_ref(x, 7, 16)
    for m in range(3):
        np.testing.assert_allclose(y[m].numpy(),
                                   tref.ota_project_ref(x[m], 7, 16).numpy(),
                                   rtol=1e-6, atol=1e-7)
