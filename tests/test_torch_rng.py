"""repro_torch.rng against jax.random (threefry2x32, partitionable mode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng

SEEDS = [0, 1, 2**31 - 1]
SHAPES = [(7,), (3, 5), (1025,)]

def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bitwise(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(kj), kt.numpy())
    for salt in (0, 1, 2, 7, 1000, 2**32 - 1):
        np.testing.assert_array_equal(_np(jax.random.fold_in(kj, salt)),
                                      rng.fold_in(kt, salt).numpy())
    for num in (1, 2, 5, 25):
        np.testing.assert_array_equal(_np(jax.random.split(kj, num)),
                                      rng.split(kt, num).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bitwise(seed, shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    kt = rng.fold_in(rng.PRNGKey(seed), 3)
    np.testing.assert_array_equal(_np(jax.random.bits(kj, shape, jnp.uint32)),
                                  rng.random_bits(kt, shape).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(kj, shape)),
                                  rng.uniform(kt, shape).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(kj, shape, minval=-2.5, maxval=7.0)),
        rng.uniform(kt, shape, -2.5, 7.0).numpy())


def test_normal_within_measured_ulp_gap():
    """normal = sqrt(2) * erf_inv(uniform(k, nextafter(-1, 0), 1)), with
    XLA's erf_inv polynomial, its float32 log and its fused multiply-adds:
    bitwise over all 300 000 draws."""
    for seed in SEEDS:
        kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
        nj = np.asarray(jax.random.normal(kj, (100_000,)))
        nt = rng.normal(kt, (100_000,)).numpy()
        np.testing.assert_array_equal(nt.view(np.int32), nj.view(np.int32))


@pytest.mark.parametrize("lo,hi", [(-0.4, 0.4), (0.4, 0.9966),
                                   (0.9966, 1.0), (-1.0, -0.9966)])
def test_erf_inv_matches_xla(lo, hi):
    """Both of log1p's branches and both of the polynomial's (w < 5 and
    w >= 5, the tails), bitwise."""
    u = rng.uniform(rng.PRNGKey(5), (100_000,), lo, hi)
    u = u[u.abs() < 1.0]
    ej = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(u.numpy())))
    np.testing.assert_array_equal(rng.erf_inv(u).numpy().view(np.int32),
                                  ej.view(np.int32))


@pytest.mark.parametrize("lo,hi", [(1e-38, 1e-30), (1e-7, 0.6), (0.6, 4.0),
                                   (4.0, 1e30)])
def test_log_f32_matches_xla(lo, hi):
    """rng.log_f32 is XLA's CPU float32 log bit for bit (torch.log is not)."""
    rs = np.random.default_rng(int(hi))
    a = np.exp(rs.uniform(np.log(lo), np.log(hi), 200_000)).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(a))
    got = rng.log_f32(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_log_f32_edges():
    a = np.array([0.0, 1e-40, -1.0, 1.0, np.inf], np.float32)
    want = np.asarray(jax.jit(jnp.log)(a))
    np.testing.assert_array_equal(rng.log_f32(torch.from_numpy(a)).numpy(),
                                  want)


def test_draws_are_device_tensors_of_the_key():
    key = rng.PRNGKey(3)
    assert rng.normal(key, (4,)).dtype == torch.float32
    assert rng.split(key, 3).shape == (3, 2)
