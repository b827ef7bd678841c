"""The port's named mesh and its collectives (``repro_torch.sharding``)
against jax's, and the kernel wrappers' shared state under rank threads.

The reference's collectives run on 8 forced host devices in one
subprocess for the module (``tests/torch_sharded_ref.py``); the port's
run on a thread mesh here, and on a 4-rank gloo process group spawned
with a ``FileStore`` under the test's ``tmp_path``.  Bars: bitwise
throughout.
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import torch_sharded_ref as R
from repro_torch import rng
from repro_torch import sharding as sh
from repro_torch.configs.base import OTAConfig
from repro_torch.core import distributed, schemes
from repro_torch.core.schemes import MACContext, get_scheme
from repro_torch.kernels import amp_fused, build, ef_sparsify, ops, ota_project
from repro_torch.sharding import Mesh, P, shard_map

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread (the rank threads are the
    parallelism here; a pool of intra-op threads per op only adds
    wake-ups on busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return R.run_reference(tmp_path_factory.mktemp("ref") / "coll.npz",
                           "collectives")


def _bits(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _one_axis(body, x):
    mesh = Mesh((R.N,), ("dev",))
    return shard_map(body, mesh, (P("dev"),), P("dev"))(torch.from_numpy(x))


def test_psum_float32_is_the_reference_bits(ref):
    """Left to right in device order, as jax's CPU psum sums."""
    _bits(_one_axis(lambda v: sh.psum(v, "dev"), ref["coll/x"]),
          ref["coll/psum_f32"])


def test_psum_bfloat16_accumulates_in_float32_and_rounds_once(ref):
    x = torch.from_numpy(ref["coll/x"]).bfloat16()
    mesh = Mesh((R.N,), ("dev",))
    got = shard_map(lambda v: sh.psum(v, "dev"), mesh, (P("dev"),),
                    P("dev"))(x)
    assert got.dtype == torch.bfloat16
    _bits(got.float(), ref["coll/psum_bf16"])
    # a sum that rounds to bfloat16 after every add is another result
    parts = x.unbind(0)
    naive = parts[0]
    for p in parts[1:]:
        naive = naive + p
    assert not torch.equal(naive, got[0])


def test_psum_groups_sum_in_member_order(ref):
    groups = [[0, 5, 2], [7, 1], [3, 4, 6]]
    _bits(_one_axis(lambda v: sh.psum(v, "dev", groups=groups),
                    ref["coll/x"]), ref["coll/psum_groups"])


@pytest.mark.parametrize("axes", [("dev",), ("shard",), ("dev", "shard"),
                                  ("shard", "dev")])
@pytest.mark.parametrize("tiled", [False, True])
def test_all_gather(ref, axes, tiled):
    """Row-major over the named axes; tiled concatenates."""
    mesh = Mesh((R.DEV, R.SHARD), ("dev", "shard"))
    xs = torch.from_numpy(ref["coll/x"][:, :6].reshape(R.DEV, R.SHARD * 6))
    got = shard_map(lambda v: sh.all_gather(v, axes, tiled=tiled)[None],
                    mesh, (P("dev", "shard"),), P(("dev", "shard")))(xs)
    _bits(got, ref[f"coll/all_gather/{'.'.join(axes)}/{int(tiled)}"])


def test_axis_index_and_size():
    mesh = Mesh((3, 2, 2), ("a", "b", "c"))

    def body():
        return torch.tensor([[sh.axis_index("a"), sh.axis_index("b"),
                              sh.axis_index("c"), sh.axis_size("a"),
                              sh.axis_size("b"), sh.axis_size("c")]])

    got = shard_map(body, mesh, (), P(("a", "b", "c")))()
    want = [[r // 4, (r // 2) % 2, r % 2, 3, 2, 2] for r in range(12)]
    assert got.tolist() == want
    with pytest.raises(RuntimeError, match="outside shard_map"):
        sh.axis_index("a")


def test_shard_map_slices_and_assembles():
    """Split dimensions reassemble from the ranks' blocks; over the axes a
    spec does not name, the output is coordinate 0's copy."""
    mesh = Mesh((2, 3), ("x", "y"))
    a = torch.arange(24.0).reshape(4, 6)

    def body(blk):
        assert blk.shape == (2, 2)
        return blk, blk + 100 * sh.axis_index("y")

    same, tagged = shard_map(body, mesh, (P("x", "y"),),
                             (P("x", "y"), P("x")))(a)
    assert torch.equal(same, a)
    assert torch.equal(tagged, a[:, :2])            # y = 0's block


def _adsgd(**kw):
    return OTAConfig(**{**dict(
        scheme="a_dsgd", projection="blocked", block_size=64, s_frac=0.5,
        k_frac=0.25, rademacher=True, p_avg=500.0, total_steps=10,
        amp_iters=5, mean_removal_steps=3), **kw})


def _slice_round(mesh, ctx, cfg, g, dl, step=0):
    sch = get_scheme(cfg, g.shape[1], mesh.shape[0], device="cpu")

    def body(g, dl):
        ghat, nd, _ = distributed.sharded_round(
            sch, g.reshape(-1), dl.reshape(-1), step, rng.PRNGKey(5), ctx)
        return ghat.reshape(1, 1, -1), nd.reshape(1, -1)

    spec = P("dev", "shard")
    return shard_map(body, mesh, (spec, spec), (spec, spec))(g, dl)


def _inputs(rows, d, seed=0):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(rows, d).astype(np.float32)),
            torch.from_numpy((0.1 * rs.randn(rows, d)).astype(np.float32)))


def _scatter_body(v):
    """Each group along ``'shard'`` scatters its first member's two
    scaled copies of its block."""
    parts = ([v * (i + 1) for i in range(2)]
             if sh.axis_index("shard") == 0 else None)
    return sh.scatter(parts, "shard", torch.empty_like(v))


def test_scatter_hands_each_member_its_block(pg_world):
    """On the process group (``pg_cases``) rank ``(d, s)`` gets ``s + 1``
    times the block of rank ``(d, 0)``; a thread mesh, whose ranks share
    their tensors, has no hand-off; only a group's first member passes
    blocks."""
    x = _pg_input()
    want = torch.stack([x[0], 2 * x[0], x[2], 2 * x[2]])
    for r, got in enumerate(pg_world()):
        assert torch.equal(got["scatter"], want), r
    mesh = Mesh((2, 2), ("dev", "shard"))
    spec = P(("dev", "shard"))
    with pytest.raises(RuntimeError, match="process-group mesh"):
        shard_map(_scatter_body, mesh, (spec,), spec)(x)

    def wrong(v):                     # the second member passes them
        parts = [v, v] if sh.axis_index("shard") else None
        return sh.scatter(parts, "shard", torch.empty_like(v))

    with pytest.raises(RuntimeError, match="first member"):
        shard_map(wrong, mesh, (spec,), spec)(x)


def test_block_shape():
    mesh = Mesh((4, 2), ("data", "model"))
    assert sh.block_shape(mesh, (4, 1024), P("data", "model")) == (1, 512)
    assert sh.block_shape(mesh, (4, 2, 64), P("data", "model", None)) == \
        (1, 1, 64)
    assert sh.block_shape(mesh, (8, 3), P(("data", "model"))) == (1, 3)
    with pytest.raises(ValueError, match="does not split"):
        sh.block_shape(mesh, (6, 4), P("data"))


def test_two_runs_are_bitwise():
    mesh = Mesh((4, 2), ("dev", "shard"))
    ctx = MACContext(m=4, device_axes=("dev",), shard_axes=("shard",),
                     d_pad=512, chunk_blocks=2, shard_decode=True)
    g, dl = _inputs(4, 512)
    a = _slice_round(mesh, ctx, _adsgd(), g, dl)
    b = _slice_round(mesh, ctx, _adsgd(), g, dl)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _rank_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("shard_map-rank-") and t.is_alive()]


def test_a_rank_that_raises_fails_every_rank():
    """The failing rank aborts the barrier: the others raise at their next
    collective, shard_map re-raises the first error, no thread is left."""
    mesh = Mesh((8,), ("dev",))

    def body(x):
        x = sh.psum(x, "dev")
        if sh.axis_index("dev") == 5:
            raise ValueError("rank five gives up")
        return sh.psum(x, "dev")

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 5") as err:
        shard_map(body, mesh, (P("dev"),), P("dev"),
                  timeout=30.0)(torch.ones(8, 3))
    assert isinstance(err.value.__cause__, ValueError)
    assert time.monotonic() - t0 < 10.0
    assert _rank_threads() == []


def test_a_rank_that_never_arrives_times_out():
    """A rank that skips a collective leaves the others at the barrier
    until its timeout: they raise, and shard_map with them."""
    mesh = Mesh((4,), ("dev",))

    def body(x):
        if sh.axis_index("dev") != 2:
            x = sh.psum(x, "dev")
        return x

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="BrokenBarrierError"):
        shard_map(body, mesh, (P("dev"),), P("dev"),
                  timeout=1.0)(torch.ones(4, 3))
    assert time.monotonic() - t0 < 10.0
    assert _rank_threads() == []


# ---------------------------------------------------------------------------
# the gloo process group gives the thread mesh's bits
# ---------------------------------------------------------------------------

_WORKER = r"""
import sys, torch
from repro_torch import rng
from repro_torch import sharding as sh
import test_torch_sharding as T

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
mesh = sh.init_process_mesh((2, 2), ("dev", "shard"), rank=rank,
                            world_size=4, init_method="file://" + store,
                            timeout=120)
try:
    from torch.distributed.device_mesh import init_device_mesh
    names = ("dev", "shard", "one")
    out3 = sh.Mesh((2, 2, 1), names, device_mesh=init_device_mesh(
        "cpu", (2, 2, 1), mesh_dim_names=names))
    torch.save({**T.pg_cases(mesh), **T.pg_one_rank_axis(out3)}, out)
finally:
    sh.close_process_mesh()
"""


def _pg_input():
    return torch.from_numpy(np.random.RandomState(4).randn(4, 1000)
                            .astype(np.float32))


def pg_cases(mesh):
    """The same bodies on either transport: the collectives, sharded_round
    (with shard_decode and a bfloat16 body) and round_sharded over both
    axes as devices; on a process group also ``scatter``."""
    g, dl = _inputs(2, 512, seed=3)
    x = _pg_input()
    out = {"coll": shard_map(
        lambda v: (sh.psum(v, ("dev", "shard")),
                   sh.psum(v.bfloat16(), "dev").float(),
                   sh.all_gather(v, ("shard", "dev"), tiled=True)[None]),
        mesh, (P(("dev", "shard")),),
        (P(None, ("dev", "shard")), P(None, ("dev", "shard")),
         P(("dev", "shard"))))(x)}
    for name, knobs in (("plain", {}), ("decode_bf16", dict(
            shard_decode=True, frame_dtype=torch.bfloat16))):
        ctx = MACContext(m=2, device_axes=("dev",), shard_axes=("shard",),
                         d_pad=512, chunk_blocks=2, **knobs)
        out[name] = _slice_round(mesh, ctx, _adsgd(), g, dl)
    g4, dl4 = _inputs(4, 512, seed=5)
    sch = get_scheme(_adsgd(), 512, 4, device="cpu")
    ctx = MACContext(m=4, device_axes=("dev", "shard"))

    def body(g, dl):
        ghat, nd, _ = schemes.round_sharded(sch, g.reshape(-1),
                                            dl.reshape(-1), 0,
                                            rng.PRNGKey(9), ctx)
        return ghat[None], nd.reshape(1, -1)

    spec = P(("dev", "shard"))
    out["round"] = shard_map(body, mesh, (spec, spec), (spec, spec))(g4, dl4)
    if mesh.processes:
        out["scatter"] = shard_map(_scatter_body, mesh, (spec,), spec)(x)
    return out


def pg_one_rank_axis(mesh):
    """Collectives over an axis of one rank (``'one'`` of a 2 x 2 x 1
    mesh), alone and after ``'shard'``."""
    spec = P(("dev", "shard"))
    return {"one": shard_map(
        lambda v: (sh.psum(v, "one") * 1, sh.psum(v, ("shard", "one")),
                   sh.all_gather(v, ("one", "shard"), tiled=True)[None]),
        mesh, (spec,), (spec, spec, spec))(_pg_input())}


@pytest.fixture(scope="module")
def pg_world(tmp_path_factory):
    """``pg_cases`` on 4 gloo processes, started once for the module;
    calling the fixture's value waits for them and returns each rank's
    results."""
    tmp = tmp_path_factory.mktemp("pg")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, os.path.dirname(os.path.abspath(__file__))])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(tmp / "store"),
         str(tmp / f"rank{r}.pt")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    results = []

    def wait():
        if not results:
            logs = [p.communicate(timeout=240)[0] for p in procs]
            assert [p.returncode for p in procs] == [0] * 4, "\n".join(logs)
            results.extend(torch.load(tmp / f"rank{r}.pt")
                           for r in range(4))
        return results

    yield wait
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_process_group_gives_the_thread_mesh_bits(pg_world):
    want = {**pg_cases(Mesh((2, 2), ("dev", "shard"))),
            **pg_one_rank_axis(Mesh((2, 2, 1), ("dev", "shard", "one")))}
    for r, got in enumerate(pg_world()):
        assert got.keys() == want.keys() | {"scatter"}
        for k in want:
            for a, b in zip(got[k], want[k]):
                assert a.dtype == b.dtype and torch.equal(a, b), (r, k)


# ---------------------------------------------------------------------------
# the kernel wrappers' shared state under rank threads
# ---------------------------------------------------------------------------


class _StubLibrary:
    """Stands in for the CUDA library: every launch returns success."""

    def __getattr__(self, name):
        return lambda *a: 0


def _hammer(fn, threads: int = 32, calls: int = 50):
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    barrier = threading.Barrier(threads)

    def work():
        barrier.wait()
        for _ in range(calls):
            fn()

    pool = [threading.Thread(target=work) for _ in range(threads)]
    try:
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    return threads * calls


def test_launch_counts_are_exact_under_32_threads(monkeypatch):
    """Each wrapper's counting path, from 32 threads against a stub
    library: not one launch is lost."""
    monkeypatch.setattr(build, "library", lambda: _StubLibrary())
    monkeypatch.setattr(build, "require_cuda_f32", lambda *a, **k: None)
    monkeypatch.setattr(build, "current_stream", lambda dev: 0)
    g = torch.zeros(2, 8)
    tau = torch.zeros(2)
    ops.reset_launches()
    n = _hammer(lambda: (ef_sparsify._launch(g, g, tau),
                         ota_project._launch(torch.zeros(1, 2, 8), 3, 4,
                                             True),
                         ota_project._launch_t(torch.zeros(1, 2, 4), 3, 8,
                                               True),
                         amp_fused._launch(torch.zeros(2, 4), 3, 8, 2, 1.3,
                                           True, True, 0)))
    assert ops.launch_counts() == {"ef_sparsify": n, "ota_project": n,
                                   "ota_project_t": n, "amp_fused": n}
    ops.reset_launches()


def test_library_builds_once_under_32_threads(monkeypatch):
    """Rank threads reaching their first launch together start one build
    and load one library."""
    builds = []

    def slow_build(verbose=False):
        builds.append(1)
        time.sleep(0.05)
        return "stub.so"

    class Lib:
        def __getattr__(self, name):
            fn = lambda *a: 0                              # noqa: E731
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(build, "_library", None)
    seen = []
    _hammer(lambda: seen.append(build.library()), calls=1)
    assert len(builds) == 1
    assert len({id(lib) for lib in seen}) == 1
