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


def _key_stack(lead):
    """Keys of shape (*lead, 2), the same in both packages."""
    n = int(np.prod(lead))
    seeds = np.arange(n, dtype=np.uint32) * 7919 + 5
    kj = jax.vmap(jax.random.PRNGKey)(seeds).reshape(*lead, 2)
    return kj, torch.from_numpy(_np(kj))


def _vmap_over(fn, lead):
    for _ in lead:
        fn = jax.vmap(fn)
    return fn


@pytest.mark.parametrize("lead", [(1,), (4,), (3, 5)])
def test_key_stack_fold_in_split_bitwise(lead):
    """A stack of keys (..., 2) gives jax.vmap's bits, and each key's bits
    are those of the same call on that key alone."""
    kj, kt = _key_stack(lead)
    for salt in (0, 1, 2, 2**32 - 1):
        want = _vmap_over(lambda k: jax.random.fold_in(k, salt), lead)(kj)
        got = rng.fold_in(kt, salt)
        np.testing.assert_array_equal(_np(want), got.numpy())
        np.testing.assert_array_equal(
            rng.fold_in(kt.reshape(-1, 2)[-1], salt).numpy(),
            got.reshape(-1, 2)[-1].numpy())
    for num in (1, 25):
        want = _vmap_over(lambda k: jax.random.split(k, num), lead)(kj)
        got = rng.split(kt, num)
        assert got.shape == (*lead, num, 2)
        np.testing.assert_array_equal(_np(want), got.numpy())


@pytest.mark.parametrize("lead", [(4,), (2, 3)])
@pytest.mark.parametrize("shape", [(7,), (3, 5)])
def test_key_stack_draws_bitwise(lead, shape):
    kj, kt = _key_stack(lead)
    bits = _vmap_over(lambda k: jax.random.bits(k, shape, jnp.uint32),
                      lead)(kj)
    np.testing.assert_array_equal(_np(bits), rng.random_bits(kt, shape)
                                  .numpy())
    uni = _vmap_over(lambda k: jax.random.uniform(k, shape), lead)(kj)
    np.testing.assert_array_equal(np.asarray(uni),
                                  rng.uniform(kt, shape).numpy())
    nrm = _vmap_over(lambda k: jax.random.normal(k, shape), lead)(kj)
    got = rng.normal(kt, shape)
    assert got.shape == (*lead, *shape)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(nrm).view(np.int32))
    flat = kt.reshape(-1, 2)
    for i in range(flat.shape[0]):
        np.testing.assert_array_equal(
            rng.normal(flat[i], shape).numpy().view(np.int32),
            got.reshape(-1, *shape)[i].numpy().view(np.int32))
