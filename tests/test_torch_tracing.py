"""The port's tracer (``repro_torch.tracing``) on a tiny ``CompiledFedLLM``
round on the CPU: nothing recorded and nothing changed when off, the span
tree of a round when on, the spans as ``record_function`` ranges under
torch's profiler once armed (and none from the profiler alone), counters,
rank threads, and cases on the card (a planted wait counted, device times
recorded; spans outside a round leave the sync mode alone).

The round: a 2-layer dense decoder (d = 90 432), a_dsgd on the blocked
projector with c = 256, m = 2 devices of 2 x 8 tokens, 5 AMP iterations,
chunks of 2^14 (6 chunks).
"""
import json
import threading
from collections import Counter

import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig, OTAConfig, TrainConfig
from repro_torch.experiments.engine import round_keys
from repro_torch.kernels import amp_fused, build, ef_sparsify, ops, ota_project
from repro_torch.train import fedllm

M = 2
CHUNK = ["stream.mac", "stream.encode", "encode.threshold", "encode.sparsify",
         "encode.project", "encode.frame", "stream.mac", "stream.decode",
         "decode.normalize", "decode.amp"]
DEVICE = ["grads.batch", "grads.forward", "grads.backward", "grads.flatten"]
#: each device's attention mixers: 2 layers, in the forward and, under
#: remat, in the backward's recompute (on the CPU, autograd runs it in the
#: calling thread, inside the round)
MIXERS = ["model.attention"] * 2 * 2


def _fed(device="cpu", scheme="a_dsgd"):
    arch = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      head_dim=16, tie_embeddings=True)
    ota = OTAConfig(scheme=scheme, projection="blocked", s_frac=0.25,
                    k_frac=0.5, block_size=256, amp_iters=5)
    return fedllm.CompiledFedLLM(arch, TrainConfig(compute_dtype="float32"),
                                 ota, m=M, batch=2, seq_len=8,
                                 chunk_size=1 << 14, seed=0, device=device)


@pytest.fixture(scope="module")
def fed():
    f = _fed()
    assert (f.d, f.n_chunks) == (90432, 6)
    return f


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _round(fed, t=1):
    keys = round_keys(t + 1, 0, device=fed.device)
    return fed.run_segment({}, keys[t:t + 1], None, fed.carry0(), t)


def _leaves(out):
    carry, outs = out
    return tree_leaves(carry) + [outs["loss"]] + [
        outs["metrics"][k] for k in sorted(outs["metrics"])]


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s["parent"] == i]


def test_off_records_nothing_and_on_is_bitwise(fed):
    assert tracing.span("round") is tracing.span("stream")   # one null span
    off = _round(fed)
    assert tracing.last_round() is None
    tracing.enable()
    on = _round(fed)
    tracing.disable()
    assert tracing.last_round() is not None
    a, b = _leaves(off), _leaves(on)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_span_tree_of_a_round(fed):
    ops.reset_launches()
    tracing.enable()
    _round(fed, t=3)
    tracing.disable()
    rec = tracing.last_round()
    spans = rec["spans"]
    assert rec["t"] == 3 and all(s["t"] == 3 for s in spans)
    assert spans[0]["name"] == "round" and spans[0]["parent"] is None
    top = [spans[j]["name"] for j in _children(spans, 0)]
    assert top == ["grads", "stream", "adam"]
    grads, stream = _children(spans, 0)[:2]
    assert [spans[j]["name"] for j in _children(spans, grads)] == DEVICE * M
    # per chunk, in the pipelined order: chunk 0's encode, then each
    # chunk's decode before the next chunk's encode
    chunk = [j for j in _children(spans, stream)]
    names = [spans[j]["name"] for j in chunk]
    n = fed.n_chunks
    encode = ["stream.mac", "stream.encode", "stream.mac"]
    assert names == encode + (["stream.decode"] + encode) * (n - 1) + [
        "stream.decode"]
    idx = [spans[j]["chunk"] for j in chunk]
    assert idx == [0] * 3 + sum(([i - 1] + [i] * 3 for i in range(1, n)),
                                []) + [n - 1]
    for j in chunk:
        kids = [spans[k]["name"] for k in _children(spans, j)]
        assert kids == {"stream.mac": [],
                        "stream.encode": CHUNK[2:6],
                        "stream.decode": CHUNK[8:]}[spans[j]["name"]]
        assert all(spans[k]["chunk"] == spans[j]["chunk"]
                   for k in _children(spans, j))
    assert Counter(s["name"] for s in spans) == Counter(
        ["round", "grads", "stream", "adam"] + DEVICE * M + CHUNK * n
        + MIXERS * M)
    for i, s in enumerate(spans):
        assert s["end_ns"] >= s["start_ns"] and s["device_ms"] is None
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
            assert s["parent"] < i
    assert rec["counters"]["chunks"] == n
    assert spans[stream]["counters"] == {"chunks": n}
    launches = {k[len("launches."):]: v for k, v in rec["counters"].items()
                if k.startswith("launches.")}
    assert {k: launches.get(k, 0) for k in ops.KERNELS} == ops.launch_counts()


def _profiled_round(fed, path):
    """A round under torch's profiler on the CPU: its exported Chrome
    trace's base time in µs and its ``repro_torch.`` ranges in the order
    they opened."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _round(fed)
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    return doc["baseTimeNanoseconds"] / 1000, sorted(
        (e for e in doc["traceEvents"] if e.get("ph") == "X"
         and e.get("name", "").startswith(tracing.PREFIX)),
        key=lambda e: (e["ts"], -e["dur"]))


def test_the_profiler_alone_does_not_arm_the_tracer(fed, tmp_path):
    _, ranges = _profiled_round(fed, tmp_path / "trace.json")
    assert ranges == []
    assert not tracing.enabled() and tracing.last_round() is None


def test_spans_are_profiler_ranges_on_the_host_clock(fed, tmp_path):
    tracing.enable()
    # the first ranges of a process pay torch's one-time set-up of the
    # profiler's ops: a first profiled round takes it out of the one read
    _profiled_round(fed, tmp_path / "warm.json")
    base_us, ranges = _profiled_round(fed, tmp_path / "trace.json")
    tracing.disable()
    spans = tracing.last_round()["spans"]
    assert [e["name"] for e in ranges] == [tracing.PREFIX + s["name"]
                                          for s in spans]
    for e, s in zip(ranges, spans):
        assert abs(e["ts"] + base_us - s["start_ns"] / 1000) < 1000
    # the ranges nest as the spans do: each range's innermost enclosing
    # range is its span's parent's
    for i, e in enumerate(ranges):
        outer = [j for j, o in enumerate(ranges) if j != i
                 and o["ts"] <= e["ts"]
                 and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
        inner = max(outer, key=lambda j: ranges[j]["ts"], default=None)
        assert inner == spans[i]["parent"]


class _StubLibrary:
    """Stands in for the CUDA library: every launch returns success."""

    def __getattr__(self, name):
        return lambda *a: 0


def test_launches_are_counters_charged_to_the_innermost_span(monkeypatch):
    monkeypatch.setattr(build, "library", lambda: _StubLibrary())
    monkeypatch.setattr(build, "require_cuda_f32", lambda *a, **k: None)
    monkeypatch.setattr(build, "current_stream", lambda dev: 0)
    g, tau = torch.zeros(2, 8), torch.zeros(2)
    ops.reset_launches()
    ef_sparsify._launch(g, g, tau)                     # off: counted still
    tracing.enable()
    with tracing.span("round", t=0):
        with tracing.span("stream.encode"):
            ef_sparsify._launch(g, g, tau)
            with tracing.span("encode.project"):
                ota_project._launch(torch.zeros(1, 2, 8), 3, 4, True)
        with tracing.span("stream.decode"):
            amp_fused._launch(torch.zeros(2, 4), 3, 8, 2, 1.3, True, True, 0)
            tracing.count("extra", 5)
    assert ops.launch_counts() == {"ef_sparsify": 2, "ota_project": 1,
                                   "ota_project_t": 0, "amp_fused": 1}
    rec = tracing.last_round()
    by = [(s["name"], s["counters"]) for s in rec["spans"]]
    assert by == [("round", {}),
                  ("stream.encode", {"launches.ef_sparsify": 1}),
                  ("encode.project", {"launches.ota_project": 1}),
                  ("stream.decode", {"launches.amp_fused": 1,
                                     "amp_fused.sign_tables": 1, "extra": 5})]
    assert rec["counters"] == {"launches.ef_sparsify": 1,
                               "launches.ota_project": 1,
                               "launches.amp_fused": 1,
                               "amp_fused.sign_tables": 1, "extra": 5}
    ops.reset_launches()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert tracing.totals()["extra"] >= 5


@pytest.mark.parametrize("rademacher,tables", [(True, 1), (False, 0)])
def test_amp_fused_counts_its_sign_tables(monkeypatch, rademacher, tables):
    """A launch of the Rademacher decode, which sums through tables of
    signed partial sums, adds 1 to ``amp_fused.sign_tables``; a Gaussian
    one adds 0.  Both count one launch."""
    monkeypatch.setattr(build, "library", lambda: _StubLibrary())
    monkeypatch.setattr(build, "require_cuda_f32", lambda *a, **k: None)
    monkeypatch.setattr(build, "current_stream", lambda dev: 0)
    before = tracing.totals().get("amp_fused.sign_tables", 0)
    launches = ops.launch_counts()["amp_fused"]
    amp_fused._launch(torch.zeros(2, 4), 3, 8, 2, 1.3, True, rademacher, 0)
    assert ops.launch_counts()["amp_fused"] == launches + 1
    assert tracing.totals().get("amp_fused.sign_tables", 0) == \
        before + tables


@pytest.mark.parametrize("scheme", ["d_dsgd", "ideal"])
def test_stream_spans_cover_every_scheme(scheme):
    """The stream's encode, MAC and decode spans sit in the stream's own
    code, so a scheme without A-DSGD's inner spans has them too."""
    f = _fed(scheme=scheme)
    tracing.enable()
    _round(f)
    tracing.disable()
    spans = tracing.last_round()["spans"]
    stream = next(i for i, s in enumerate(spans) if s["name"] == "stream")
    kids = [spans[j] for j in _children(spans, stream)]
    n = f.n_chunks
    for name, per in (("stream.encode", 1), ("stream.mac", 2),
                      ("stream.decode", 1)):
        got = sorted(s["chunk"] for s in kids if s["name"] == name)
        assert got == sorted(list(range(n)) * per)
    assert {s["name"] for s in spans} == {
        "round", "grads", "stream", "adam", "stream.encode", "stream.mac",
        "stream.decode"} | set(DEVICE) | set(MIXERS)


def test_only_a_round_tree_is_kept():
    tracing.enable()
    tracing.reset("outside")
    with tracing.span("stream.encode"):
        with tracing.span("encode.frame"):
            tracing.count("outside", 2)
    assert tracing.last_round() is None
    assert tracing.totals()["outside"] == 2
    with tracing.span("round", t=7):
        pass
    with tracing.span("stream.decode"):
        pass
    rec = tracing.last_round()
    assert [s["name"] for s in rec["spans"]] == ["round"]
    assert rec["t"] == 7
    assert tracing.last_round() is rec                 # read once, kept


def test_spans_nest_per_thread():
    """Rank threads each keep their own stack: every kept tree is one
    thread's, with its own children only."""
    tracing.enable()
    barrier = threading.Barrier(8)
    seen = []

    def work(r):
        barrier.wait()
        for _ in range(20):
            with tracing.span("round", t=r):
                for i in range(3):
                    tracing.at_chunk(i)
                    with tracing.span("stream.encode"):
                        with tracing.span("encode.threshold"):
                            pass
            seen.append(tracing.last_round())

    pool = [threading.Thread(target=work, args=(r,)) for r in range(8)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(60)
    assert len(seen) == 160
    for rec in seen:
        spans = rec["spans"]
        assert [s["name"] for s in spans] == (
            ["round"] + ["stream.encode", "encode.threshold"] * 3)
        assert [s["parent"] for s in spans] == [None, 0, 1, 0, 3, 0, 5]
        assert {s["t"] for s in spans} == {rec["t"]}
        assert [s["chunk"] for s in spans[1:]] == [0, 0, 1, 1, 2, 2]


@pytest.mark.cuda
def test_host_sync_counted_and_device_ms_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(1 << 20, device="cuda")
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    tracing.enable()
    with tracing.span("round", t=0):
        with tracing.span("stream.encode"):
            for _ in range(50):
                x = x * 1.0001 + 1.0
        with tracing.span("stream.decode"):
            x.sum().item()                                # one wait
    tracing.disable()
    assert torch.cuda.get_sync_debug_mode() == mode
    rec = tracing.last_round()
    counters = {s["name"]: s["counters"] for s in rec["spans"]}
    assert counters["stream.decode"] == {"host_syncs": 1}
    assert counters["stream.encode"] == {}
    assert rec["counters"]["host_syncs"] == 1
    assert isinstance(rec["counters"]["device_mallocs"], int)
    assert rec["counters"]["alloc_retries"] == 0
    ms = {s["name"]: s["device_ms"] for s in rec["spans"]}
    assert ms["stream.encode"] > 0 and ms["stream.decode"] > 0
    assert ms["round"] >= ms["stream.encode"] + ms["stream.decode"]


@pytest.mark.cuda
def test_spans_outside_a_round_leave_the_card_alone(monkeypatch):
    """A span tree with no ``round`` above it (a rank thread's encode in
    the sharded trainer) records no CUDA event and leaves torch's sync
    debug mode as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.zeros(1, device="cuda")
    made = []
    monkeypatch.setattr(tracing, "_event", lambda: made.append(1))
    mode = torch.cuda.get_sync_debug_mode()
    tracing.enable()
    with tracing.span("stream.encode"):
        assert torch.cuda.get_sync_debug_mode() == mode
        with tracing.span("encode.frame"):
            torch.ones(4, device="cuda").sum().item()
    tracing.disable()
    assert made == [] and tracing.last_round() is None
