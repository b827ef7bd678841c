"""The CUDA kernels against their plain versions on the card.

Marked ``cuda``: they skip where no CUDA device is present.  On a machine
with one, from the root of the checkout:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.amp import amp_blocked_core
from repro_torch.kernels import amp_fused, ef_sparsify, ops, ota_project, ref

pytestmark = pytest.mark.cuda

SHAPES = [(1, 128, 32), (3, 256, 64), (4, 512, 128), (2, 384, 96),
          (5, 64, 16)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import resolve_device
    return resolve_device(None)


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("m,n", [(1, 5), (3, 10007), (25, 7850)])
def test_ef_sparsify_bitwise(dev, m, n):
    gen = _gen(dev, n)
    g = torch.randn(m, n, generator=gen, device=dev)
    d = torch.randn(m, n, generator=gen, device=dev)
    tau = torch.rand(m, generator=gen, device=dev)
    before = ef_sparsify.launches
    sp, nd = ef_sparsify.ef_sparsify(g, d, tau)
    sr, dr = ref.ef_sparsify_ref(g, d, tau)
    assert ef_sparsify.launches == before + 1
    assert torch.equal(sp, sr) and torch.equal(nd, dr)


@pytest.mark.parametrize("nb,c,sb", SHAPES)
@pytest.mark.parametrize("rademacher", [True, False])
@pytest.mark.parametrize("m", [1, 3, 25])
def test_ota_project(dev, nb, c, sb, rademacher, m):
    x = torch.randn(m, nb, c, generator=_gen(dev, nb * c + m), device=dev)
    seed = torch.tensor(0xDEADBEEF, dtype=torch.int64, device=dev)
    y = ota_project.ota_project(x, seed, sb, rademacher)
    np.testing.assert_allclose(
        y.cpu().numpy(), ref.ota_project_ref(x, seed, sb, rademacher).cpu().numpy(),
        rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("rademacher", [True, False])
def test_amp_fused(dev, rademacher):
    nb, c, sb = 8, 256, 128
    gen = _gen(dev, 3)
    x = torch.zeros(nb, c, device=dev)
    for b in range(nb):
        x[b, torch.randperm(c, generator=gen, device=dev)[:sb // 8]] = 1.0
    yb = ref.ota_project_ref(x, 9, sb, rademacher)
    out = amp_fused.amp_decode_fused(yb, 9, c, iters=20,
                                     rademacher=rademacher)
    want = amp_blocked_core(yb, 9, c, iters=20, rademacher=rademacher)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    part = amp_fused.amp_decode_fused(yb[3:].contiguous(), 9, c, iters=20,
                                      rademacher=rademacher, id_offset=3)
    assert torch.equal(part, out[3:])


# (n_blocks, c, s_block): bench_kernels.py's shapes and a ragged c that is
# no multiple of the kernel's 256 columns per CTA
T_SHAPES = SHAPES + [(2, 4096, 1024), (3, 1000, 100)]


@pytest.mark.parametrize("nb,c,sb", T_SHAPES)
@pytest.mark.parametrize("rademacher", [True, False])
@pytest.mark.parametrize("m", [1, 25])
def test_ota_project_t(dev, nb, c, sb, rademacher, m):
    y = torch.randn(m, nb, sb, generator=_gen(dev, nb * sb + m), device=dev)
    seed = torch.tensor(0xDEADBEEF, dtype=torch.int64, device=dev)
    before = ota_project.launches_t
    r = ops.ota_project_t(y, seed=seed, c=c, rademacher=rademacher,
                          use_kernel=True)
    assert ota_project.launches_t == before + 1
    assert r.shape == (m, nb, c)
    np.testing.assert_allclose(
        r.cpu().numpy(), ref.ota_project_t_ref(y, seed, c, rademacher).cpu().numpy(),
        rtol=3e-5, atol=3e-5)
    again = ops.ota_project_t(y, seed=seed, c=c, rademacher=rademacher,
                              use_kernel=True)
    assert torch.equal(r, again)


def test_ota_project_t_adjoint_identity(dev):
    nb, c, sb = 3, 1000, 100
    gen = _gen(dev, 11)
    x = torch.randn(nb, c, generator=gen, device=dev)
    y = torch.randn(nb, sb, generator=gen, device=dev)
    ax = ota_project.ota_project(x, 5, sb)
    aty = ota_project.ota_project_t(y, 5, c)
    np.testing.assert_allclose(float((ax.double() * y.double()).sum()),
                               float((x.double() * aty.double()).sum()),
                               rtol=1e-4)


def test_unfused_decode_on_card(dev):
    """amp_decode_blocked on a use_kernel projector: iters adjoint and
    iters + 1 forward launches, and the plain projector's decode."""
    from repro_torch.core.amp import amp_decode_blocked
    from repro_torch.core.projection import BlockedProjector
    nb, c, sb, iters = 4, 512, 128, 10
    gen = _gen(dev, 5)
    x = torch.zeros(nb, c, device=dev)
    for b in range(nb):
        x[b, torch.randperm(c, generator=gen, device=dev)[:sb // 8]] = 1.0
    proj = BlockedProjector(d=nb * c, block_size=c, s_block=sb, seed=9,
                            use_kernel=True)
    yb = ref.ota_project_ref(x, 9, sb) \
        + 0.01 * torch.randn(nb, sb, generator=gen, device=dev)
    ops.reset_launches()
    out = amp_decode_blocked(yb, proj, iters=iters)
    counts = ops.launch_counts()
    assert counts["ota_project_t"] == iters
    assert counts["ota_project"] == iters + 1
    plain = amp_decode_blocked(
        yb, BlockedProjector(d=nb * c, block_size=c, s_block=sb, seed=9),
        iters=iters)
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


def test_run_federated_on_card_matches_cpu(dev):
    from repro_torch.configs.base import OTAConfig
    from repro_torch.data import federated_split, make_classification
    from repro_torch.train.paper_repro import run_federated
    (xtr, ytr), (xte, yte) = make_classification(n_train=400, n_test=300,
                                                 dim=64, seed=1)
    xd, yd = federated_split(xtr, ytr, m=4, b=32, seed=0)
    cfg = OTAConfig(projection="blocked", block_size=128, s_frac=0.5,
                    k_frac=0.25, rademacher=True, use_kernel=True,
                    total_steps=5, amp_iters=10, mean_removal_steps=2)
    ops.reset_launches()
    rg = run_federated(xd, yd, xte, yte, cfg, steps=5, eval_every=1)
    # the fused decode: the adjoint kernel is not on this path
    assert ops.launch_counts() == {"ef_sparsify": 5, "ota_project": 5,
                                   "ota_project_t": 0, "amp_fused": 5}
    rc = run_federated(xd, yd, xte, yte, cfg, steps=5, eval_every=1,
                       device="cpu")
    np.testing.assert_allclose(rg.losses, rc.losses, rtol=1e-4, atol=1e-5)
