"""The plain reference held against the port on the CPU at a tiny size.

The test imports the port; the reference itself does not.  On the CPU
both sides run the same equations in the same precision, so they agree
bit for bit: every gap the check reads is 0."""
import json
import math

import numpy as np
import pytest
import torch

from fedbench.drivers import fedllm_round
from fedbench.reference import ota, rng
from fedbench.reference import transformer as tfm
from fedbench.tests import tiny

SEED = 2**31 + 11


def tiny_workload(name: str) -> dict:
    wl = json.loads((tiny.REPO / "fedbench" / "workloads"
                     / "smollm_360m.adsgd_round.json").read_text())
    wl["round"].update(chunk_len=4096, expect=tiny.EXPECT[name])
    wl["ota"]["block_size"] = 256
    return wl


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_three_rounds_equal_the_port(name):
    config, wl = tiny.tiny_config(name), tiny_workload(name)
    cell = fedllm_round.Cell(config, wl, SEED, "cpu")
    got = cell.setup()
    checked = cell.check(got, "cpu")
    assert got["losses"] == checked["reference_losses"]
    gaps = checked["gaps"]
    assert (gaps["loss_gap"], gaps["grad_gap"], gaps["change_gap"]) \
        == (0.0, 0.0, 0.0)
    assert gaps["left_out"] == [] and min(got["change"].values()) > 0


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_weights_equal_the_ports(name):
    from repro_torch.models import model
    from repro_torch import rng as port_rng

    config = tiny.tiny_config(name)
    mine = tfm.init_params(tfm.Arch.from_config(config), SEED, "cpu")
    theirs = model.init_params(fedllm_round.port_arch(config),
                               port_rng.PRNGKey(SEED))
    assert tfm.leaf_names(mine) == [
        n for n in tfm.leaf_names(theirs)]
    for a, b in zip(tfm.leaves(mine), tfm.leaves(theirs)):
        assert torch.equal(a, b)


def test_rng_equals_the_ports():
    from repro_torch import rng as port

    k = port.PRNGKey(SEED)
    mine = rng.PRNGKey(SEED)
    assert torch.equal(port.fold_in(k, 9), rng.fold_in(mine, 9))
    assert torch.equal(port.split(k, 7), rng.split(mine, 7))
    for f, args in [("normal", ((33, 7),)), ("uniform", ((100,),)),
                    ("truncated_normal", (-2.0, 2.0, (9, 11))),
                    ("randint", ((2, 16), 0, 49155))]:
        assert torch.equal(getattr(port, f)(k, *args),
                           getattr(rng, f)(mine, *args)), f


def test_block_matrices_equal_the_ports():
    from repro_torch.kernels import ref as port

    ids = torch.arange(3, 6, dtype=torch.int64)
    assert torch.equal(ota.block_matrices(7, 3, 3, 16, 64, "cpu"),
                       port.block_matrix_ref(7, ids, 16, 64))


def test_tf32_keeps_ten_mantissa_bits_rounding_to_nearest_even():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      1.0 + 2**-11 + 2**-20, -3.14159265], dtype=torch.float32)
    got = ota.tf32(x)
    assert got[0] == 1.0 + 2**-10
    assert got[1] == 1.0                       # a tie goes to even
    assert got[2] == 1.0 + 2 * 2**-10          # a tie goes to even
    assert got[3] == 1.0 + 2**-10
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(float(got[4]) + math.pi) < 2**-9


def test_amp_equals_the_ports_plain_decode():
    from repro_torch.core.amp import amp_blocked_core

    gen = torch.Generator().manual_seed(0)
    n, s, c = 4, 64, 256
    A = ota.block_matrices(0, 0, n, s, c, "cpu")
    x = torch.zeros((n, c))
    x[:, ::17] = torch.randn((n, len(range(0, c, 17))), generator=gen)
    y = (x.double()[:, None, :] @ A.double().transpose(1, 2)).float()[:, 0]
    y = y + 0.01 * torch.randn(y.shape, generator=gen)
    theirs = amp_blocked_core(y, 0, c, iters=20)
    mine = ota.amp(y[:, None, :], A, 20, "float64")[:, 0]
    assert torch.equal(mine, theirs)


def test_threshold_equals_the_ports():
    from repro_torch.core.compression import sampled_topk_threshold

    v = torch.randn((4, 1 << 18), generator=torch.Generator().manual_seed(1))
    assert torch.equal(ota.threshold(v, 1 << 15),
                       sampled_topk_threshold(v, 1 << 15))


def test_frame_and_receiver_equal_the_ports():
    from repro_torch.core import channel

    g = torch.randn((4, 4096), generator=torch.Generator().manual_seed(2))
    p = torch.full((4,), np.float32(500.0))
    theirs, _ = channel.make_frame(g, p, True)
    assert torch.equal(ota.frame(g, p, True), theirs)
    keys = rng.split(rng.PRNGKey(5), 3)
    z = ota.noise(keys, theirs.shape[-1], 1.0)
    for i in range(3):
        y = channel.ps_normalize(channel.mac_sum(theirs, keys[i], 1.0), True)
        assert torch.equal(ota.receive(theirs, z[i], True), y)
