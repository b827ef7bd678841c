#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, one JSON line each:

1. env      torch and CUDA versions, the card's name and power limit;
2. build    the kernels, compiled from ``src/repro_torch/kernels/csrc``;
3. kernel_checks
            each hand-written kernel against its plain PyTorch version on
            the same CUDA tensors, at the main path's shapes and at the
            "medium" shape of ``benchmarks/bench_kernels.py``: ef_sparsify
            bitwise, ota_project and its adjoint ota_project_t at
            rtol = atol = 3e-5 (Rademacher and Gaussian entries), amp_fused
            at rtol 1e-4 / atol 1e-5 with an ``id_offset`` sub-range
            bitwise; times by CUDA events (median);
4. slice    the port's ``run_federated`` at the paper's full scale: the
            single-layer model (d = 7850) on the MNIST surrogate, M = 25
            devices of B = 1000 samples, 60 000 / 10 000 samples, blocked
            A-DSGD with ``ota_overrides("mnist_mlp")`` and ``use_kernel``,
            20 AMP iterations, 20 rounds.  ef_sparsify, ota_project and
            amp_fused must each launch in that run, the test loss must
            fall, and the first round's gradient estimate must equal the
            plain path's;
5. unfused_decode
            the launch-per-op AMP decode (``amp_decode_blocked``) on a
            ``use_kernel`` projector at the slice's decode shape (2 blocks,
            1024 -> 4096, 20 iterations, noisy y): exactly 20 launches of
            ota_project_t and 21 of ota_project, and the result within
            rtol 1e-4 / atol 1e-5 of the plain projector's decode and of
            the fused kernel's; its time beside both;
6. engine   the port's ``run_compiled`` at the slice's scale and config:
            its accuracies and losses equal the slice phase's
            ``run_federated`` run, a checkpointed run stopped at round 10
            and resumed equals the uninterrupted one bitwise, no host sync
            inside the loop, and its ms per round;
7. kernels  the per-kernel record: route, source, the TPU kernel it
            replaces, launches on its path (and on every path), error,
            times and bound.

Each path (slice, unfused_decode, engine) runs with every launch count set
to 0 just before it and read just after.

The card's name and power limit are printed again before the last line,
which is ``{"ok": true, "device": {...}}``.  Any failed check raises, and
the script exits non-zero; without a CUDA device it exits 2 at once.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet):
#: HBM bytes/s and float32 FLOP/s outside the tensor cores.  The hash's
#: integer operations are counted at the float32 rate too, which can only
#: make the bound smaller, so it stays a lower bound on the kernel's time.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: integer operations per entry of A: one lowbias32 stage (9) + the column xor
HASH_OPS = 10
#: a Gaussian entry adds a second stage, the uniform maps and Box-Muller
GAUSS_EXTRA_OPS = 20

STEPS = 20
WARMUP, REPS = 3, 20

_SOURCES = "src/repro_torch/kernels"
KERNELS = {
    "ef_sparsify": dict(
        source=f"{_SOURCES}/csrc/ef_sparsify.cu",
        replaces="src/repro/kernels/ef_sparsify.py:28 ef_sparsify_pallas"),
    "ota_project": dict(
        source=f"{_SOURCES}/csrc/ota_project.cu",
        replaces="src/repro/kernels/ota_project.py:134 ota_project_pallas"),
    "ota_project_t": dict(
        source=f"{_SOURCES}/csrc/ota_project_t.cu",
        replaces="src/repro/kernels/ota_project.py:173 ota_project_t_pallas"),
    "amp_fused": dict(
        source=f"{_SOURCES}/csrc/amp_fused.cu",
        replaces="src/repro/kernels/amp_fused.py:72 amp_decode_fused_pallas"),
}
#: the path each kernel's ``launches`` is read from, and the kernels each
#: path must launch
KERNEL_PATH = {"ef_sparsify": "slice", "ota_project": "slice",
               "ota_project_t": "unfused_decode", "amp_fused": "slice"}
PATH_KERNELS = {"slice": ("ef_sparsify", "ota_project", "amp_fused"),
                "unfused_decode": ("ota_project", "ota_project_t"),
                "engine": ("ef_sparsify", "ota_project", "amp_fused")}


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = WARMUP, reps: int = REPS) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float):
    """(least time in ms, what bounds it) on the H100's published peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def errors(out, want):
    diff = (out - want).abs()
    rel = diff / want.abs().clamp(min=1e-30)
    return float(diff.max()), float(rel.max())


def mismatch(out, want, rtol: float, atol: float) -> str:
    """Where ``out`` leaves ``allclose(want, rtol, atol)``, for a message."""
    bad = (out - want).abs() > atol + rtol * want.abs()
    worst = int(((out - want).abs() - rtol * want.abs()).argmax())
    return (f"{int(bad.sum())} of {out.numel()} entries outside "
            f"rtol={rtol} atol={atol}; worst at {worst}: "
            f"{float(out.reshape(-1)[worst])} vs {float(want.reshape(-1)[worst])}")


def block_sparse(n_blocks: int, c: int, per_block: int, gen, device):
    import torch
    x = torch.zeros(n_blocks, c, device=device)
    for b in range(n_blocks):
        idx = torch.randperm(c, generator=gen, device=device)[:per_block]
        x[b, idx] = torch.randn(per_block, generator=gen, device=device)
    return x


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_ef_sparsify(m: int, n: int, k: int, device, gen):
    import torch
    from repro_torch.core.compression import sampled_topk_threshold
    from repro_torch.kernels import ef_sparsify, ref
    g = torch.randn(m, n, generator=gen, device=device)
    delta = 0.3 * torch.randn(m, n, generator=gen, device=device)
    tau = sampled_topk_threshold(g + delta, k)
    sp, nd = ef_sparsify.ef_sparsify(g, delta, tau)
    sp_ref, nd_ref = ref.ef_sparsify_ref(g, delta, tau)
    torch.cuda.synchronize()
    check(torch.equal(sp, sp_ref) and torch.equal(nd, nd_ref),
          f"ef_sparsify {m}x{n}: not bitwise equal to its plain version")
    n_bytes = 4 * (4 * m * n + m)
    return dict(
        kernel="ef_sparsify", shape=[m, n], tol="bitwise",
        max_abs_err=max(errors(sp, sp_ref)[0], errors(nd, nd_ref)[0]),
        max_rel_err=0.0,
        kernel_ms=cuda_ms(lambda: ef_sparsify.ef_sparsify(g, delta, tau)),
        plain_ms=cuda_ms(lambda: ref.ef_sparsify_ref(g, delta, tau)),
        library_ms=None, bound=bound(n_bytes, 3 * m * n))


def check_ota_project(m: int, n_blocks: int, c: int, s: int, rademacher: bool,
                      device, gen):
    import torch
    from repro_torch.kernels import ota_project, ref
    x = torch.randn(m, n_blocks, c, generator=gen, device=device)
    seed = 12345
    y = ota_project.ota_project(x, seed, s, rademacher)
    y_ref = ref.ota_project_ref(x, seed, s, rademacher)
    torch.cuda.synchronize()
    check(torch.allclose(y, y_ref, rtol=3e-5, atol=3e-5),
          f"ota_project {m}x{n_blocks}x{c}->{s} rademacher={rademacher}: "
          f"max abs err {errors(y, y_ref)[0]} above 3e-5")
    # yardstick: one batched product with A materialised beforehand
    A = ref.block_matrix_ref(seed, torch.arange(n_blocks, device=device), s,
                             c, rademacher)
    xt = x.permute(1, 2, 0).contiguous()                  # (n_blocks, c, m)
    entries = n_blocks * s * c
    n_ops = entries * (HASH_OPS + (0 if rademacher else GAUSS_EXTRA_OPS)) \
        + 2 * m * entries
    abs_err, rel_err = errors(y, y_ref)
    return dict(
        kernel="ota_project", shape=[m, n_blocks, c, s],
        entries="rademacher" if rademacher else "gaussian",
        tol="rtol=atol=3e-5", max_abs_err=abs_err, max_rel_err=rel_err,
        kernel_ms=cuda_ms(lambda: ota_project.ota_project(x, seed, s,
                                                          rademacher)),
        plain_ms=cuda_ms(lambda: ref.ota_project_ref(x, seed, s, rademacher)),
        library_ms=cuda_ms(lambda: torch.bmm(A, xt)),
        bound=bound(4 * (m * n_blocks * c + m * n_blocks * s), n_ops))


def check_ota_project_t(m: int, n_blocks: int, s: int, c: int,
                        rademacher: bool, device, gen):
    import torch
    from repro_torch.kernels import ota_project, ref
    y = torch.randn(m, n_blocks, s, generator=gen, device=device)
    seed = 12345
    r = ota_project.ota_project_t(y, seed, c, rademacher)
    r_ref = ref.ota_project_t_ref(y, seed, c, rademacher)
    again = ota_project.ota_project_t(y, seed, c, rademacher)
    torch.cuda.synchronize()
    check(torch.allclose(r, r_ref, rtol=3e-5, atol=3e-5),
          f"ota_project_t {m}x{n_blocks}x{s}->{c} rademacher={rademacher}: "
          + mismatch(r, r_ref, 3e-5, 3e-5))
    check(torch.equal(r, again), "ota_project_t: two runs differ")
    # yardstick: one batched product with A materialised beforehand
    A_t = ref.block_matrix_ref(seed, torch.arange(n_blocks, device=device),
                               s, c, rademacher).transpose(1, 2).contiguous()
    yt = y.permute(1, 2, 0).contiguous()                  # (n_blocks, s, m)
    entries = n_blocks * s * c
    n_ops = entries * (HASH_OPS + (0 if rademacher else GAUSS_EXTRA_OPS)) \
        + 2 * m * entries
    abs_err, rel_err = errors(r, r_ref)
    return dict(
        kernel="ota_project_t", shape=[m, n_blocks, s, c],
        entries="rademacher" if rademacher else "gaussian",
        tol="rtol=atol=3e-5", max_abs_err=abs_err, max_rel_err=rel_err,
        bitwise=bool(torch.equal(r, r_ref)),
        kernel_ms=cuda_ms(lambda: ota_project.ota_project_t(y, seed, c,
                                                            rademacher)),
        plain_ms=cuda_ms(lambda: ref.ota_project_t_ref(y, seed, c,
                                                       rademacher)),
        library_ms=cuda_ms(lambda: torch.bmm(A_t, yt)),
        bound=bound(4 * (m * n_blocks * s + m * n_blocks * c), n_ops))


def check_amp_fused(n_blocks: int, c: int, s: int, iters: int, device, gen):
    import torch
    from repro_torch.core.amp import amp_blocked_core
    from repro_torch.kernels import amp_fused, ref
    seed = 777
    # a block-sparse signal (k/s = 1/8, well inside AMP's recovery region at
    # s/c = 1/4) observed with noise, as the main path's y carries AWGN.
    # Without noise, AMP drives sigma and the threshold towards zero and the
    # support of the near-zero entries turns on rounding: there two plain
    # float32 and float64 decodes of one input already differ past the bar
    x = block_sparse(n_blocks, c, s // 8, gen, device)
    yb = ref.ota_project_ref(x, seed, s) \
        + 0.01 * torch.randn(n_blocks, s, generator=gen, device=device)
    out = amp_fused.amp_decode_fused(yb, seed, c, iters=iters)
    want = amp_blocked_core(yb, seed, c, iters=iters, use_kernel=False)
    again = amp_fused.amp_decode_fused(yb, seed, c, iters=iters)
    half = n_blocks // 2
    part = amp_fused.amp_decode_fused(yb[half:].contiguous(), seed, c,
                                      iters=iters, id_offset=half)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(out, want)
    check(torch.allclose(out, want, rtol=1e-4, atol=1e-5),
          f"amp_fused {n_blocks}x{s}->{c}: "
          + mismatch(out, want, 1e-4, 1e-5))
    check(torch.equal(out, again), "amp_fused: two runs differ")
    check(torch.equal(part, out[half:]),
          "amp_fused: the id_offset sub-range is not bitwise the full "
          "decode's rows")
    recovery = float((out - x).norm() / x.norm())
    check(recovery < 0.2, f"amp_fused: relative recovery error {recovery}")
    entries = n_blocks * s * c
    n_ops = (2 * iters + 1) * 2 * entries + HASH_OPS * entries
    return dict(
        kernel="amp_fused", shape=[n_blocks, s, c], iters=iters,
        tol="rtol=1e-4 atol=1e-5; id_offset sub-range bitwise",
        max_abs_err=abs_err, max_rel_err=rel_err, recovery_rel_err=recovery,
        kernel_ms=cuda_ms(lambda: amp_fused.amp_decode_fused(
            yb, seed, c, iters=iters)),
        plain_ms=cuda_ms(lambda: amp_blocked_core(yb, seed, c, iters=iters,
                                                  use_kernel=False)),
        library_ms=None, bound=bound(4 * (n_blocks * s + n_blocks * c), n_ops))


# ---------------------------------------------------------------------------
# phase 4: the port's main path
# ---------------------------------------------------------------------------


def slice_config(steps: int):
    from repro_torch.configs.base import ota_overrides
    return dataclasses.replace(ota_overrides("mnist_mlp"), use_kernel=True,
                               amp_iters=20, total_steps=steps)


def round_parity(xd, yd, cfg, device):
    """The first round's gradient estimate, kernel path against plain path."""
    import torch
    from repro_torch import rng
    from repro_torch.core.schemes import get_scheme, round_simulated
    from repro_torch.train.paper_repro import device_grads, init_linear
    params = init_linear(xd.shape[-1], 10, device)
    grads, _ = device_grads(params, xd, yd, None)
    deltas = torch.zeros_like(grads)
    out = {}
    for uk in (True, False):
        scheme = get_scheme(dataclasses.replace(cfg, use_kernel=uk),
                            grads.shape[1], grads.shape[0], device=device)
        out[uk] = round_simulated(scheme, grads, deltas, 0,
                                  rng.PRNGKey(1000, device=device))
    (g_k, d_k, _), (g_p, d_p, _) = out[True], out[False]
    torch.cuda.synchronize()
    check(torch.equal(d_k, d_p), "first round: kernel and plain error "
          "states differ (ef_sparsify is bitwise)")
    abs_err, rel_err = errors(g_k, g_p)
    check(torch.allclose(g_k, g_p, rtol=1e-4, atol=1e-5),
          "first round: ghat kernel vs plain: "
          + mismatch(g_k, g_p, 1e-4, 1e-5))
    return dict(max_abs_err=abs_err, max_rel_err=rel_err)


def round_breakdown(xd, yd, cfg, device, reps: int = 10):
    """ms of one round and of its parts, steady state, by CUDA events."""
    import torch
    from repro_torch import rng
    from repro_torch.core import channel
    from repro_torch.core.schemes import encode_round, get_scheme
    from repro_torch.core.schemes import MACContext
    from repro_torch.convert import unravel
    from repro_torch.optim.optim import Optimizer
    from repro_torch.train.paper_repro import (device_grads, init_linear,
                                               train_step)
    params = init_linear(xd.shape[-1], 10, device)
    grads, _ = device_grads(params, xd, yd, None)
    scheme = get_scheme(cfg, grads.shape[1], grads.shape[0], device=device)
    opt = Optimizer(lr=1e-3)
    state = opt.init(params)
    deltas = torch.zeros_like(grads)
    key = rng.PRNGKey(1000, device=device)
    ctx = MACContext(m=scheme.m)
    y, _, _, _ = encode_round(scheme, grads, deltas, 0, key, ctx)
    ghat = scheme.decode(y, 0, ctx)
    return {
        "round_ms": cuda_ms(lambda: train_step(
            scheme, opt, params, state, deltas, None, xd, yd, 0, key),
            reps=reps),
        "device_grads_ms": cuda_ms(lambda: device_grads(params, xd, yd, None),
                                   reps=reps),
        "encode_and_mac_ms": cuda_ms(lambda: encode_round(
            scheme, grads, deltas, 0, key, ctx), reps=reps),
        "decode_ms": cuda_ms(lambda: scheme.decode(y, 0, ctx), reps=reps),
        # the round's draws from the jax-exact RNG: the three salted keys,
        # the device keys and the AWGN of the MAC
        "rng_ms": cuda_ms(lambda: (
            rng.split(rng.fold_in(key, 1), scheme.m), rng.fold_in(key, 2),
            channel.awgn(rng.fold_in(key, 0), y.shape, 1.0)), reps=reps),
        "adam_ms": cuda_ms(lambda: opt.apply(params, unravel(ghat, params),
                                             state), reps=reps),
    }


def run_slice(device, steps: int = STEPS, m: int = 25, b: int = 1000,
              n_train: int = 60000, n_test: int = 10000):
    import numpy as np
    import torch
    from repro_torch.data import federated_split, make_classification
    from repro_torch.kernels import ops
    from repro_torch.train.paper_repro import run_federated

    t0 = time.perf_counter()
    # the figure benchmarks' surrogate at the paper's FULL scale
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=n_train, n_test=n_test, noise=6.0, seed=3)
    x_dev, y_dev = federated_split(xtr, ytr, m=m, b=b, iid=True, seed=0)
    data_s = time.perf_counter() - t0
    cfg = slice_config(steps)
    xd = torch.as_tensor(x_dev, device=device)
    yd = torch.as_tensor(y_dev, device=device).long()

    parity = round_parity(xd, yd, cfg, device)

    ops.reset_launches()
    t0 = time.perf_counter()
    run = run_federated(x_dev, y_dev, xte, yte, cfg, steps=steps, lr=1e-3,
                        eval_every=5, device=device)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(all(np.isfinite(run.losses)) and run.losses[-1] < run.losses[0],
          f"slice: test loss did not fall: {run.losses}")
    d = int(run.deltas.shape[1])
    check(d == 7850, f"slice: d = {d}, expected 7850")
    check(run.deltas.shape[0] == m, f"slice: M != {m}")
    for name in PATH_KERNELS["slice"]:
        check(launches[name] > 0,
              f"slice: kernel {name} never launched in run_federated")
    timing = round_breakdown(xd, yd, cfg, device)
    return (x_dev, y_dev, xte, yte), dict(
        phase="slice", m=m, b=b, n_train=n_train, n_test=n_test, d=d,
        steps=steps, config=dict(projection=cfg.projection,
                                 block_size=cfg.block_size,
                                 s_frac=cfg.s_frac, k_frac=cfg.k_frac,
                                 rademacher=cfg.rademacher,
                                 use_kernel=cfg.use_kernel,
                                 amp_iters=cfg.amp_iters),
        launches=launches, launches_per_round={
            k: v / steps for k, v in launches.items()},
        first_round_ghat_vs_plain=parity, losses=run.losses, accs=run.accs,
        final_acc=run.accs[-1], data_s=data_s, run_s=run_s, **timing)


# ---------------------------------------------------------------------------
# phase 5: the launch-per-op AMP decode on the adjoint and forward kernels
# ---------------------------------------------------------------------------


def run_unfused_decode(n_blocks: int, c: int, s: int, iters: int, device,
                       gen):
    import torch
    from repro_torch.core.amp import amp_decode_blocked
    from repro_torch.core.projection import BlockedProjector
    from repro_torch.kernels import amp_fused, ops, ref
    seed = 777
    x = block_sparse(n_blocks, c, s // 8, gen, device)
    yb = ref.ota_project_ref(x, seed, s) \
        + 0.01 * torch.randn(n_blocks, s, generator=gen, device=device)
    kw = dict(d=n_blocks * c, block_size=c, s_block=s, seed=seed)
    kproj = BlockedProjector(use_kernel=True, **kw)
    pproj = BlockedProjector(use_kernel=False, **kw)

    ops.reset_launches()
    out = amp_decode_blocked(yb, kproj, iters=iters)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {"ef_sparsify": 0, "ota_project": iters + 1,
            "ota_project_t": iters, "amp_fused": 0}
    check(launches == want, f"unfused_decode: launches {launches}, "
          f"expected {want}")
    plain = amp_decode_blocked(yb, pproj, iters=iters)
    fused = amp_fused.amp_decode_fused(yb, seed, c, iters=iters).reshape(-1)
    torch.cuda.synchronize()
    for name, other in (("plain projector", plain), ("amp_fused", fused)):
        check(torch.allclose(out, other, rtol=1e-4, atol=1e-5),
              f"unfused_decode vs {name}: "
              + mismatch(out, other, 1e-4, 1e-5))
    recovery = float((out - x.reshape(-1)).norm() / x.norm())
    check(recovery < 0.2, f"unfused_decode: relative recovery error "
          f"{recovery}")
    return dict(
        phase="unfused_decode", shape=[n_blocks, s, c], iters=iters,
        launches=launches, tol="rtol=1e-4 atol=1e-5",
        max_abs_err_vs_plain=errors(out, plain)[0],
        max_abs_err_vs_fused=errors(out, fused)[0],
        bitwise_vs_plain=bool(torch.equal(out, plain)),
        recovery_rel_err=recovery,
        unfused_kernel_ms=cuda_ms(lambda: amp_decode_blocked(
            yb, kproj, iters=iters), reps=10),
        unfused_plain_ms=cuda_ms(lambda: amp_decode_blocked(
            yb, pproj, iters=iters), reps=10),
        fused_kernel_ms=cuda_ms(lambda: amp_fused.amp_decode_fused(
            yb, seed, c, iters=iters), reps=10))


# ---------------------------------------------------------------------------
# phase 6: the engine, and its checkpointed resume
# ---------------------------------------------------------------------------


def run_engine(data, cfg, slice_line, device, steps: int = STEPS,
               eval_every: int = 5, stop_at: int = 10):
    import tempfile
    import warnings
    import torch
    from repro_torch.experiments import engine
    from repro_torch.kernels import ops

    ops.reset_launches()
    t0 = time.perf_counter()
    run = engine.run_compiled(*data, cfg, steps=steps, lr=1e-3,
                              eval_every=eval_every, device=device)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    for name in PATH_KERNELS["engine"]:
        check(launches[name] > 0,
              f"engine: kernel {name} never launched in run_compiled")
    check(run.accs == slice_line["accs"] and run.losses
          == slice_line["losses"],
          f"engine: run_compiled {run.accs} {run.losses} differs from "
          f"run_federated {slice_line['accs']} {slice_line['losses']}")

    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(steps=steps, lr=1e-3, eval_every=eval_every,
                  device=device, checkpoint_dir=tmp,
                  checkpoint_every=eval_every)
        stopped = engine.run_compiled(*data, cfg, stop_after_step=stop_at,
                                      **kw)
        check(stopped is None, "engine: the interrupted run did not stop")
        resumed = engine.run_compiled(*data, cfg, resume=True, **kw)
    torch.cuda.synchronize()
    check(resumed.accs == run.accs and resumed.losses == run.losses
          and resumed.all_losses.tolist() == run.all_losses.tolist()
          and all(torch.equal(resumed.params[k], run.params[k])
                  for k in run.params),
          "engine: the resumed run is not bitwise the uninterrupted one")

    # steady state: the same runner, its loop alone, by CUDA events; and
    # whether anything inside the loop waits for the device
    exp = engine.Experiment(cfg=cfg, steps=steps, eval_every=eval_every)
    ce = engine.CompiledExperiment(*data, exp, device=device)
    keys = engine.round_keys(steps, 0, device)
    ce.run({}, keys)
    torch.cuda.synchronize()

    def sync_warnings(fn):
        """torch's warnings of synchronizing calls made by ``fn()`` (its
        notice that the debug mode is a prototype is not one)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        msgs = [str(w.message).splitlines()[0] for w in caught]
        return [m for m in msgs if "synchroniz" in m.lower()
                and "prototype" not in m]

    check(sync_warnings(lambda: keys[0, 1].item()) != [],
          "engine: the sync detector does not see an .item()")
    syncs = sync_warnings(lambda: ce.run({}, keys))
    check(not syncs, f"engine: host syncs inside the loop: {syncs[:5]}")
    run_ms = cuda_ms(lambda: ce.run({}, keys), warmup=1, reps=3)
    return dict(
        phase="engine", steps=steps, launches=launches,
        launches_per_round={k: v / steps for k, v in launches.items()},
        equals_run_federated=True, resumed_bitwise=True,
        checkpoint=dict(every=eval_every, stopped_after=stop_at),
        host_syncs_in_loop=len(syncs), losses=run.losses, accs=run.accs,
        run_s=run_s, ms_per_round=run_ms / steps,
        run_federated_round_ms=slice_line["round_ms"])


# ---------------------------------------------------------------------------


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    device = resolve_device(None)
    smi = nvidia_smi()
    emit(dict(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
              python=sys.version.split()[0], nvidia_smi=smi,
              device=torch.cuda.get_device_name(0),
              tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
              tf32_cudnn=torch.backends.cudnn.allow_tf32))
    print(smi, flush=True)

    t0 = time.perf_counter()
    build.library()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              library=build.library_path().name))

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cfg = slice_config(STEPS)
    d, c = 7850, cfg.block_size
    s = max(2, int(round(cfg.s_frac * c)))
    n_blocks = -(-d // c)
    k = max(1, int(cfg.k_frac * n_blocks * s))
    main_checks = {
        "ef_sparsify": check_ef_sparsify(25, d, k, device, gen),
        "ota_project": check_ota_project(25, n_blocks, c, s, cfg.rademacher,
                                         device, gen),
        # the adjoint at its path's shape: one decode's z, 1024 -> 4096
        "ota_project_t": check_ota_project_t(1, n_blocks, s, c,
                                             cfg.rademacher, device, gen),
        "amp_fused": check_amp_fused(n_blocks, c, s, cfg.amp_iters, device,
                                     gen),
    }
    extra = [
        check_ef_sparsify(3, 10007, 1000, device, gen),
        check_ota_project(25, n_blocks, c, s, False, device, gen),
        check_ota_project(1, 64, 1024, 256, True, device, gen),
        check_ota_project(1, 64, 1024, 256, False, device, gen),
        check_ota_project_t(1, 64, 256, 1024, True, device, gen),
        check_ota_project_t(1, 64, 256, 1024, False, device, gen),
        check_amp_fused(64, 1024, 256, 10, device, gen),
    ]
    emit(dict(phase="kernel_checks", main_path=list(main_checks.values()),
              other_shapes=extra, not_ported=[]))

    data, sl = run_slice(device)
    emit(sl)
    ud = run_unfused_decode(n_blocks, c, s, cfg.amp_iters, device, gen)
    emit(ud)
    eng = run_engine(data, cfg, sl, device)
    emit(eng)

    paths = {"slice": sl["launches"], "unfused_decode": ud["launches"],
             "engine": eng["launches"]}
    kernels = []
    for name, meta in KERNELS.items():
        chk = main_checks[name]
        bound_ms, bound_by = chk["bound"]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=paths[KERNEL_PATH[name]][name],
            max_abs_err=chk["max_abs_err"], ms=chk["kernel_ms"],
            plain_ms=chk["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=chk["library_ms"], shape=chk["shape"],
            max_rel_err=chk["max_rel_err"], kernel_ms=chk["kernel_ms"],
            ported=True, path=KERNEL_PATH[name],
            launches_per_path={p: n[name] for p, n in paths.items()}))
    check(len(kernels) == 4 and all(k["ported"] for k in kernels),
          "kernels: not all four TPU kernels are ported")
    emit({"kernels": kernels})

    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
