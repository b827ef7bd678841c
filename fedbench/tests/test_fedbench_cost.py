"""The frozen cost model: each kernel's bound at the cells' shapes, the
same as the port's own cost model gives, and the round's least time."""
import pytest

from fedbench.cost import kernels, round as round_cost
from fedbench.tests import tiny

SMOLLM = {"m": 4, "batch": 2, "seq_len": 16, "d": 361_821_120,
          "n_chunks": 87, "blocks": 1024, "c": 4096, "s": 1024, "iters": 20}


@pytest.mark.parametrize("cost, ms", [
    (kernels.amp_fused(1, 1024, 1024, 4096, 20), 5.90),
    (kernels.ota_project(4, 1024, 4096, 1024), 1.154),
    (kernels.ef_sparsify(4, 4_194_304), 0.0801),
])
def test_bounds_at_the_streamed_shapes(cost, ms):
    """The kernel table's bounds at one chunk of the streamed round."""
    assert kernels.bound(*cost)[0] == pytest.approx(ms, rel=2e-3)


@pytest.mark.parametrize("args", [(4, 1024), (25, 7850), (1, 180_912_128)])
def test_frozen_copy_equals_the_ports_cost_model(args):
    from repro_torch.kernels import cost as port

    assert kernels.ef_sparsify(*args) == tuple(port.ef_sparsify(*args))
    shape = (args[0], 16, 4096, 1024)
    assert kernels.ota_project(*shape) == tuple(port.ota_project(*shape))
    amp = (args[0], 16, 1024, 4096, 20)
    assert kernels.amp_fused(*amp) == tuple(port.amp_fused(*amp))
    assert kernels.bound(3e9, 4e12) == port.bound(3e9, 4e12)


def test_forward_flops_by_hand():
    """A 1-layer dense model, 1 x 4 tokens, counted term by term."""
    arch = dict(hidden_size=8, num_attention_heads=2, num_key_value_heads=1,
                head_dim=4, intermediate_size=16, vocab_size=10,
                num_hidden_layers=1)
    proj = 2 * 4 * (8 * 8 + 2 * 8 * 4 + 8 * 8)  # q, k and v, o
    mlp = 4 * 2 * 3 * 8 * 16
    attn = 2 * 2 * 2 * 4 * (1 + 2 + 3 + 4)    # scores and values, causal
    head = 2 * 8 * 10 * 3
    assert round_cost.forward_flops(arch, 1, 4) == proj + mlp + attn + head


def test_moe_counts_the_active_experts():
    """Top-2 of 8 experts of width 32: two dense MLPs of width 32 and the
    router, a token and a layer."""
    moe = tiny.tiny_config("tiny_moe")
    dense = dict(tiny.tiny_config("tiny_dense"), intermediate_size=32)
    no_mlp = dict(dense, intermediate_size=0)
    flops = [round_cost.forward_flops(c, 2, 16) for c in (moe, dense, no_mlp)]
    router = 2 * 64 * 8 * (2 * 16) * 2
    assert flops[0] - flops[2] == 2 * (flops[1] - flops[2]) + router


def test_smollm_round_is_bound_by_the_kernels_operations():
    arch = {"hidden_size": 960, "num_attention_heads": 15,
            "num_key_value_heads": 5, "intermediate_size": 2560,
            "vocab_size": 49152, "num_hidden_layers": 32}
    t = round_cost.least_round_s(arch, SMOLLM)
    assert t["least_s"] == t["cuda_core_s"] == pytest.approx(0.613, rel=2e-3)
    assert t["tensor_s"] < 1e-3 and t["hbm_s"] < 0.05
