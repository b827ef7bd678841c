"""The port's dry run (``repro_torch.launch.dryrun``), production meshes and
kernel costs (``repro_torch.kernels.cost``), against the reference's dry
run and by closed forms.

The reference runs on 512 forced host devices in one subprocess for the
module (``tests/torch_dryrun_ref.py``, part ``dryrun``), started before
the port's side; the port traces on ``meta`` tensors.

Bars:

* the production meshes, ``input_specs``, ``decode_window_for``,
  ``SKIPS``: equal;
* prefill and decode records on 16 x 16: ``argument_bytes`` and
  ``output_bytes`` equal to the byte to the reference's ``dryrun_one``;
* train layouts: ``d``, ``d_pad``, ``m_devices``, the error state's shape
  and each argument's per-device bytes equal to the reference's
  ``TrainStep`` on an Auto mesh (its ``NamedSharding.shard_shape``);
* the counter: a matmul's FLOPs and bytes, a ``sharded_round``'s
  collective bytes per rank, each kernel's meta route (shapes, dtypes and
  counts): equal to their closed forms;
* ``cost.bound``: ``PERF.md``'s kernel table to its printed digits.
"""
import dataclasses
import math

import pytest
import torch

import torch_dryrun_ref as R
from repro_torch import rng
from repro_torch.configs import (
    ARCH_IDS, INPUT_SHAPES, OTAConfig, TrainConfig, get_config,
)
from repro_torch.core import distributed
from repro_torch.core.schemes import MACContext, get_scheme
from repro_torch.kernels import amp_fused, cost, ef_sparsify, ops, ota_project
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import Mesh, P, shard_map

META = torch.device("meta")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference, started before the module's first test."""
    ref = R.Reference(tmp_path_factory.mktemp("dryrun_ref"), "dryrun")
    yield ref
    ref.close()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(ref):
    yield


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_equals_reference(ref, multi_pod):
    m = make_production_mesh(multi_pod=multi_pod)
    want = ref["meshes"]["mp" if multi_pod else "sp"]
    assert list(m.shape) == want["shape"]
    assert list(m.axis_names) == want["axis_names"]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_input_specs_and_windows_equal_reference(ref, arch_id):
    arch = get_config(arch_id)
    for shape_id, shape in INPUT_SHAPES.items():
        got = dryrun.input_specs(arch, shape)
        want = ref["input_specs"][f"{arch_id}/{shape_id}"]
        assert {k: {"shape": list(v.shape), "dtype": _dtype_name(v.dtype)}
                for k, v in got.items()} == want["inputs"]
        assert all(v.device == META for v in got.values())
        assert dryrun.decode_window_for(arch, shape) == want["window"]


def test_skips_and_long_window_equal_reference(ref):
    assert [[a, s, r] for (a, s), r in dryrun.SKIPS.items()] == ref["skips"]
    assert dryrun.LONG_WINDOW == ref["long_window"]
    assert dryrun.dryrun_one("whisper_base", "long_500k", False) == {
        "skipped": dryrun.SKIPS[("whisper_base", "long_500k")]}


@pytest.mark.parametrize("case", R.SERVE_CASES, ids="/".join)
def test_serve_record_bytes_equal_reference(ref, case):
    arch_id, shape_id = case
    got = dryrun.dryrun_one(arch_id, shape_id, False)
    want = ref["records"][f"{arch_id}/{shape_id}"]
    for k in ("argument_bytes", "output_bytes"):
        assert got["mem_per_device"][k] == want["mem_per_device"][k], k
    for k in ("arch", "shape", "mesh", "n_chips", "aggregator", "variant",
              "kind", "model_params", "active_params"):
        assert got[k] == want[k], k
    assert got.get("decode_window") == want.get("decode_window")
    assert got["mem_per_device"]["generated_code_bytes"] is None
    assert set(got["collective_bytes"]) == set(want["collective_bytes"])
    assert got["flops"] > 0 and got["bytes_accessed"] > 0
    assert got["mem_per_device"]["temp_bytes"] > 0


def test_reference_train_shape_fails_on_explicit_axes(ref):
    """The reference's own ``dryrun_one`` fails at ``train_4k``: its
    production mesh has Explicit axes on jax 0.9.0 (ROADMAP §3)."""
    err = ref["train_error"]
    assert err is not None and err.startswith("ValueError")
    assert "can only refer to Auto axes" in err


@pytest.mark.parametrize("name", list(R.TRAIN_CASES))
def test_train_layout_equals_reference_auto_mesh(ref, name):
    arch_id, multi_pod, over = R.TRAIN_CASES[name]
    arch = get_config(arch_id)
    train_cfg = dryrun.production_train_cfg()
    lay = dryrun.train_layout(
        arch, train_cfg, dryrun.production_ota(arch_id, ota_kw=over),
        make_production_mesh(multi_pod=multi_pod),
        ("pod", "data") if multi_pod else ("data",),
        dryrun.input_specs(arch, INPUT_SHAPES["train_4k"], train_cfg))
    ts, want = lay.step, ref["train_layouts"][name]
    assert (ts.d, ts.d_pad, ts.m_devices) == (want["d"], want["d_pad"],
                                              want["m_devices"])
    shape = ts.delta_shape
    assert (list(map(list, shape)) if isinstance(shape[0], tuple)
            else list(shape)) == want["delta_shape"]
    sizes = dict(zip(ts.mesh.axis_names, ts.mesh.shape))
    got = {
        "params_bytes": dryrun.tree_shard_bytes(lay.params,
                                                ts.param_sharding, sizes),
        "opt_bytes": dryrun.tree_shard_bytes(lay.opt_state, ts.opt_sharding,
                                             sizes),
        "delta_bytes": dryrun.tree_shard_bytes(lay.delta, ts.delta_sharding,
                                               sizes),
        "batch_bytes": dryrun.tree_shard_bytes(lay.batch, ts.batch_spec,
                                               sizes)}
    assert got == {k: want[k] for k in got}
    assert lay.argument_bytes() == (sum(got.values()) + dryrun.SCALAR_BYTES
                                    + dryrun.KEY_BYTES)


# ---------------------------------------------------------------------------
# the counter, by closed forms
# ---------------------------------------------------------------------------


def _counter(shape=(4, 2), names=("data", "model")):
    return dryrun.Counter(Mesh(shape, names))


def test_counter_counts_one_matmul():
    m, k, n = 96, 64, 80
    a = torch.empty(m, k, device=META)
    b = torch.empty(k, n, device=META)
    c = _counter()
    with c:
        out = a @ b
    dev = c.devices[(0, 0)]
    assert out.shape == (m, n) and out.device == META
    assert dev.flops == 2 * m * k * n
    assert dev.bytes_accessed == 4 * (m * k + k * n + m * n)
    assert c.peak == 4 * m * n and c.off_meta == []


def test_counter_repeats_a_cached_op_exactly():
    """A second op on the same metadata is counted as the first (its
    outputs made from the first's), and freed storage leaves the live
    count."""
    a = torch.empty(50, 30, device=META)
    c = _counter()
    with c:
        x = a * 2.0
        del x
        y = a * 2.0
    assert y.shape == (50, 30) and y.stride() == (30, 1)
    assert c.devices[(0, 0)].bytes_accessed == 2 * (2 * 4 * 50 * 30)
    assert c.live == 4 * 50 * 30 and c.peak == 4 * 50 * 30


def test_sharded_round_collective_bytes_per_rank():
    """A-DSGD's slice round on a 4 x 2 thread mesh: each rank gathers the
    shards' |g| samples, sums the frame's mean and energy over the shard
    axis and the frame's body and slots over the device axis."""
    devs, shards, c, s = 4, 2, 512, 128
    d_pad = c * shards * 3
    ota = OTAConfig(scheme="a_dsgd", projection="blocked", block_size=c,
                    s_frac=s / c, k_frac=0.5, amp_iters=4, use_kernel=True)
    scheme = get_scheme(ota, d_pad, devs, device=META)
    ctx = MACContext(m=devs, device_axes=("data",), shard_axes=("model",),
                     d_pad=d_pad, use_kernel=True)
    mesh = Mesh((devs, shards), ("data", "model"))
    g = torch.empty(devs, d_pad, device=META)
    delta = torch.empty(devs, d_pad, device=META)
    key = rng.PRNGKey(3, device=META)

    def body(gs, ds):
        gh, nd, _ = distributed.sharded_round(scheme, gs.reshape(-1),
                                              ds.reshape(-1), 0, key, ctx)
        return gh[None], nd[None]

    counter = dryrun.Counter(mesh)
    spec = P("data", "model")
    with counter:
        ghat, nd = shard_map(body, mesh, (spec, spec), (spec, spec))(g, delta)
    assert ghat.shape == (devs, d_pad) and nd.device == META
    d_local = d_pad // shards
    n_s = d_local // max(1, d_local // ctx.sample_per_shard)
    body_bytes = 4 * (d_local // c) * s
    want = {"all-gather": 4 * shards * n_s,
            "all-reduce": 4 + 4 + body_bytes + 4 * 2}
    assert len(counter.devices) == devs * shards
    for key_, dev in counter.devices.items():
        assert dev.collective["all-gather"] == want["all-gather"], key_
        assert dev.collective["all-reduce"] == want["all-reduce"], key_
    whole = counter.whole()
    assert whole["collective_bytes"]["total"] == devs * shards * sum(
        want.values())
    assert counter.kernels == {
        "ef_sparsify": {"calls": devs * shards,
                        "bytes": devs * shards * cost.ef_sparsify(
                            1, d_local).n_bytes,
                        "ops": devs * shards * cost.ef_sparsify(
                            1, d_local).n_ops},
        "ota_project": {"calls": devs * shards,
                        "bytes": devs * shards * cost.ota_project(
                            1, d_local // c, c, s).n_bytes,
                        "ops": devs * shards * cost.ota_project(
                            1, d_local // c, c, s).n_ops},
        "amp_fused": {"calls": devs * shards,
                      "bytes": devs * shards * cost.amp_fused(
                          1, d_local // c, s, c, 4).n_bytes,
                      "ops": devs * shards * cost.amp_fused(
                          1, d_local // c, s, c, 4).n_ops}}
    assert counter.off_meta == []


def _kernel_cases(device):
    """Each kernel's wrapper on inputs of ``device``: (name, call, cost)."""
    gen = torch.Generator().manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    g, dl, tau = randn(3, 700), randn(3, 700), torch.full((3,), 0.5).to(device)
    x, y = randn(2, 3, 64), randn(2, 3, 16)
    yb, yg = randn(2, 16), randn(2, 2, 16)
    return [
        ("ef_sparsify", lambda: ef_sparsify.ef_sparsify(g, dl, tau),
         cost.ef_sparsify(3, 700)),
        ("ota_project", lambda: ota_project.ota_project(x, 5, 16),
         cost.ota_project(2, 3, 64, 16)),
        ("ota_project_t", lambda: ota_project.ota_project_t(y, 5, 64),
         cost.ota_project_t(2, 3, 16, 64)),
        ("amp_fused", lambda: amp_fused.amp_decode_fused(yb, 5, 64, iters=3),
         cost.amp_fused(1, 2, 16, 64, 3)),
        ("amp_fused", lambda: amp_fused.amp_decode_fused(yg, 5, 64, iters=3),
         cost.amp_fused(2, 2, 16, 64, 3)),
    ]


@pytest.mark.parametrize("i", range(5))
def test_kernel_meta_route_shapes_and_counts(i):
    """The meta route gives the plain version's shapes and dtypes on the
    same inputs, adds exactly ``cost.py``'s counts to the active counter,
    and launches nothing."""
    name, call, want_cost = _kernel_cases("meta")[i]
    _, plain, _ = _kernel_cases("cpu")[i]
    ops.reset_launches()
    c = _counter()
    with c:
        out = call()
    want = plain()
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    assert [(o.shape, o.dtype, o.device.type) for o in outs] == \
        [(w.shape, w.dtype, "meta") for w in wants]
    assert c.kernels == {name: {"calls": 1, "bytes": want_cost.n_bytes,
                                "ops": want_cost.n_ops}}
    dev = c.devices[(0, 0)]
    assert dev.flops == want_cost.n_ops
    assert dev.bytes_accessed == want_cost.n_bytes
    assert sum(ops.launch_counts().values()) == 0
    # outside a counter the route records nothing and still shapes
    again = call()
    assert (again[0] if isinstance(again, tuple) else again).device == META


def test_kernel_meta_route_checks_its_inputs():
    g = torch.empty(2, 8, dtype=torch.float64, device=META)
    with pytest.raises(TypeError, match="float32"):
        ef_sparsify.ef_sparsify(g, g, torch.empty(2, device=META,
                                                  dtype=torch.float64))
    g = torch.empty(2, 8, device=META)
    with pytest.raises(ValueError, match="shapes"):
        ef_sparsify.ef_sparsify(g, g, torch.empty(3, device=META))
    with pytest.raises(ValueError, match="n_blocks"):
        ota_project.ota_project(torch.empty(8, device=META), 0, 4)
    with pytest.raises(ValueError, match="contiguous"):
        amp_fused.amp_decode_fused(torch.empty(16, 2, device=META).t(), 0, 8)


def test_reduced_train_step_traces_on_meta_only():
    """A reduced smollm step on a 4 x 2 thread mesh: nothing made off
    ``meta`` but the host's 0-dim seeds and shard indices, one call of
    each main-path kernel a rank, and the optimizer's work on device 0."""
    arch = get_config("smollm_360m").reduced()
    train_cfg = TrainConfig(compute_dtype="bfloat16", remat=True,
                            total_steps=10)
    ota = dataclasses.replace(dryrun.production_ota("smollm_360m"),
                              block_size=512)
    mesh = Mesh((4, 2), ("data", "model"))
    batch = {"tokens": torch.empty((8, 32), dtype=torch.int32, device=META)}
    lay = dryrun.train_layout(arch, train_cfg, ota, mesh, ("data",), batch)
    counter = dryrun.Counter(mesh)
    extra, out_bytes = dryrun.trace_train(lay, counter)
    assert counter.off_meta == []
    assert counter.host_scalars > 0
    assert {k: v["calls"] for k, v in counter.kernels.items()} == {
        "ef_sparsify": 8, "ota_project": 8, "amp_fused": 8}
    assert extra["d"] == lay.step.d and extra["m_devices"] == 4
    assert len(counter.devices) == 8
    rec = dryrun.counted_record(counter, lay.argument_bytes(counter),
                                out_bytes, extra)
    assert rec["busiest_device"] == [0, 0]
    assert rec["mem_per_device"]["argument_bytes"] == lay.argument_bytes()
    assert rec["thread_mesh"]["flops"] >= rec["flops"] > 0
    assert rec["thread_mesh"]["temp_bytes"] >= rec["mem_per_device"][
        "temp_bytes"] > 0


# ---------------------------------------------------------------------------
# cost.py against PERF.md's kernel table
# ---------------------------------------------------------------------------

#: (cost, the bound column as the table prints it, bound by)
TABLE = [
    (cost.ef_sparsify(25, 7850), "0.00094", "bytes"),
    (cost.ef_sparsify(4, 16384), "0.00031", "bytes"),
    (cost.ef_sparsify(4, 4194304), "0.0801", "bytes"),
    (cost.ef_sparsify(1, 180912128), "0.864", "bytes"),
    (cost.ota_project(25, 2, 4096, 1024), "0.0075", "operations"),
    (cost.ota_project(1, 1, 4096, 1024), "0.00075", "operations"),
    (cost.ota_project(4, 4, 4096, 1024), "0.0045", "operations"),
    (cost.ota_project(4, 1024, 4096, 1024), "1.154", "operations"),
    (cost.ota_project(1, 44168, 4096, 1024), "33.18", "operations"),
    (cost.ota_project(1, 64, 1024, 256), "0.0030", "operations"),
    (cost.ota_project(1, 256, 4096, 1024), "0.1923", "operations"),
    (cost.ota_project_t(1, 2, 1024, 4096), "0.0015", "operations"),
    (cost.ota_project_t(1, 64, 256, 1024), "0.0030", "operations"),
    (cost.ota_project_t(1, 256, 1024, 4096), "0.1923", "operations"),
    (cost.amp_fused(1, 2, 1024, 4096, 20), "0.0115", "operations"),
    (cost.amp_fused(1, 1, 1024, 4096, 20), "0.0058", "operations"),
    (cost.amp_fused(1, 4, 1024, 4096, 20), "0.0230", "operations"),
    (cost.amp_fused(1, 1024, 1024, 4096, 20), "5.90", "operations"),
    (cost.amp_fused(1, 11042, 1024, 4096, 20), "63.59", "operations"),
    (cost.amp_fused(1, 64, 256, 1024, 10), "0.0130", "operations"),
    (cost.amp_fused(1, 256, 1024, 4096, 20), "1.474", "operations"),
]


@pytest.mark.parametrize("work,printed,by", TABLE,
                         ids=[f"{i}-{p}" for i, (_, p, _) in
                              enumerate(TABLE)])
def test_bound_reproduces_the_kernel_table(work, printed, by):
    ms, got_by = cost.bound(*work)
    decimals = len(printed.split(".")[1])
    assert abs(ms - float(printed)) <= 0.5 * 10 ** -decimals + 1e-12
    assert got_by == by


def test_bound_is_the_larger_time():
    assert cost.bound(3.35e12, 0) == (1e3, "bytes")
    assert cost.bound(0, 67e12) == (1e3, "operations")
    assert math.isclose(cost.bound(3.35e9, 134e9)[0], 2.0)
