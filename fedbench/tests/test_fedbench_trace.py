"""The reduction from a trace to the per-layer metrics, on a made-up
trace: busy and idle time, kernel classes, rooflines, the breakdown."""
import pytest

from fedbench import bench, trace
from fedbench.cost import kernels

SHAPES = {"m": 4, "batch": 2, "seq_len": 16, "d": 361_821_120,
          "n_chunks": 87, "blocks": 1024, "c": 4096, "s": 1024, "iters": 20}
CONFIG = {"hidden_size": 960, "num_attention_heads": 15,
          "num_key_value_heads": 5, "intermediate_size": 2560,
          "vocab_size": 49152, "num_hidden_layers": 32}


def made_up(amp_us: float = 65_920.0) -> trace.Trace:
    """One round of 200 ms: gradients (a GEMM and an add), then a chunk's
    encode and decode, with idle gaps between."""
    k = [("ampere_sgemm_128x64_nn", 1_000.0, 21_000.0),
         ("void at::native::vectorized_elementwise_kernel<4>", 25_000.0,
          30_000.0),
         ("(anonymous namespace)::ef_sparsify_kernel(float const*)",
          40_000.0, 40_100.0),
         ("(anonymous namespace)::ota_project_kernel(float const*)",
          40_100.0, 43_800.0),
         ("(anonymous namespace)::amp_fused_kernel(float const*)",
          50_000.0, 50_000.0 + amp_us)]
    ops = k + [("Memcpy HtoD (Pageable -> Device)", 30_000.0, 31_000.0)]
    notes = [("fedbench.round", 0.0, 200_000.0),
             ("fedbench.grads", 0.0, 32_000.0),
             ("fedbench.aggregate", 32_000.0, 190_000.0),
             ("fedbench.adam", 190_000.0, 200_000.0)]
    return trace.Trace(rounds=1, kernels=k, ops=ops, annotations=notes,
                       spans={"grads": [31.0], "aggregate": [158.0]},
                       round_s=0.25, shapes=SHAPES, config=CONFIG)


def read(name, tr):
    return bench.load_module("metrics", name).read(tr)


def test_kernel_classes():
    assert trace.kernel_class("(anonymous namespace)::amp_fused_kernel(float)") \
        == "port"
    assert trace.port_kernel("ota_project_t_kernel(float)") \
        == "ota_project_t_kernel"
    assert trace.kernel_class("nvjet_tst_128x64_64x4_1x2_h_bz_TNT") \
        == "library"
    assert trace.kernel_class("void at::native::reduce_kernel<512, 1>") \
        == "other"


def test_busy_idle_and_window():
    tr = made_up()
    assert tr.window_s == pytest.approx(0.2)
    busy = 20_000 + 5_000 + 1_000 + 3_800 + 65_920
    assert tr.busy_s() == pytest.approx(busy * 1e-6)
    assert read("device_idle_pct", tr) == pytest.approx(
        100 * (1 - busy / 200_000))


def test_spans_and_elementwise():
    tr = made_up()
    assert read("grads_ms", tr) == 31.0
    assert read("aggregate_ms", tr) == 158.0
    assert read("elementwise_ms", tr) == pytest.approx(5.0)


def test_rooflines_from_the_frozen_cost():
    tr = made_up()
    assert read("amp_fused_roofline", tr) == pytest.approx(
        100 * 5.898 / 65.92, rel=1e-3)
    bound = kernels.bound(*kernels.ota_project(4, 1024, 4096, 1024))[0]
    assert read("ota_project_roofline", tr) == pytest.approx(
        100 * bound / 3.7)
    # a kernel as fast as its bound reads 100 % and no more
    at_bound = made_up(amp_us=kernels.bound(
        *kernels.amp_fused(1, 1024, 1024, 4096, 20))[0] * 1e3)
    assert read("amp_fused_roofline", at_bound) == pytest.approx(100.0)


def test_a_metric_with_nothing_to_read_is_left_out():
    tr = made_up()
    tr.kernels = [x for x in tr.kernels if "amp_fused" not in x[0]]
    assert read("amp_fused_roofline", tr) is None
    tr.spans = {}
    assert read("grads_ms", tr) is None


def test_round_mfu_is_the_least_round_over_the_window():
    from fedbench.cost.round import least_round_s

    least = least_round_s(CONFIG, SHAPES)["least_s"]
    assert least == pytest.approx(0.6135, rel=1e-3)
    assert read("round_mfu", made_up()) == pytest.approx(100 * least / 0.25)


def test_breakdown_ranks_ops_and_labels_gaps_by_host_span():
    b = trace.breakdown(made_up())
    assert b["device_ops"][0][0].startswith("(anonymous namespace)::amp")
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    gaps = dict((round(s * 1e6), lab) for lab, s in b["idle_gaps"])
    # 50_000 + 65_920 .. 200_000 begins in the aggregation's span
    assert gaps[200_000 - 115_920] == "aggregate"
    assert gaps[1_000] == "grads"
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(
        0.2 - made_up().busy_s())
