"""Time the PyTorch port's AWGN round on the card, to compare two trees.

Drives the slice of ``chip_smoke.py`` (mnist_mlp at full width, d = 7850,
the blocked kernel projector with ``use_kernel``, 25 devices of 1000
samples of the 60 000-sample surrogate) from the tree at ``--root``:

* ``engine``: ``CompiledExperiment.run`` of ``--steps`` rounds, each of
  ``--reps`` runs timed alone by CUDA events (ms per round), with the host's
  enqueue time (the call's wall time before the synchronise, ms per round);
* ``train_step``: one ``run_federated`` round, ``--reps`` calls by CUDA
  events;
* ``device_grads``: the device gradients alone, likewise.

Prints one JSON line with every repetition, the medians, the host's load
average and the card's name and power limit.  Two trees are compared by
running the script once per tree, in turns, in one call on one card::

    git archive HEAD | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 tools/torch_engine_timing.py --root "$t"; done
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _events_ms(fn, reps: int):
    """CUDA-event ms of each of ``reps`` calls, and the host ms of each
    call up to its return (before the synchronise)."""
    import torch
    dev_ms, host_ms = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
    return dev_ms, host_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1],
                    help="a checkout of the repo whose port is timed")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_engine_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.configs.base import ota_overrides
    from repro_torch.core.schemes import get_scheme
    from repro_torch.data import federated_split, make_classification
    from repro_torch.experiments import engine
    from repro_torch.kernels import build
    from repro_torch.optim.optim import Optimizer
    from repro_torch.train.paper_repro import (device_grads, init_linear,
                                               train_step)
    from repro_torch import rng

    build.build()
    dev = torch.device("cuda")
    steps = args.steps
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=60000, n_test=10000, noise=6.0, seed=3)
    x_dev, y_dev = federated_split(xtr, ytr, m=25, b=1000, iid=True, seed=0)
    cfg = dataclasses.replace(ota_overrides("mnist_mlp"), use_kernel=True,
                              amp_iters=20, total_steps=steps)

    exp = engine.Experiment(cfg=cfg, steps=steps, eval_every=5)
    ce = engine.CompiledExperiment(x_dev, y_dev, xte, yte, exp, device=dev)
    keys = engine.round_keys(steps, 0, dev)
    for _ in range(2):
        acc = float(ce.run({}, keys)["acc"][-1])
    eng_dev, eng_host = _events_ms(lambda: ce.run({}, keys), args.reps)

    xd = torch.as_tensor(x_dev, device=dev)
    yd = torch.as_tensor(y_dev, device=dev).long()
    params = init_linear(xd.shape[-1], 10, dev)
    grads, _ = device_grads(params, xd, yd, None)
    scheme = get_scheme(cfg, grads.shape[1], grads.shape[0], device=dev)
    opt = Optimizer(lr=1e-3)
    state = opt.init(params)
    deltas = torch.zeros_like(grads)
    key = rng.PRNGKey(1000, device=dev)

    def step():
        train_step(scheme, opt, params, state, deltas, None, xd, yd, 0, key)
    step()
    ts_dev, ts_host = _events_ms(step, args.reps)
    device_grads(params, xd, yd, None)
    dg_dev, _ = _events_ms(lambda: device_grads(params, xd, yd, None),
                           args.reps)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    per_round = [v / steps for v in eng_dev]
    print(json.dumps(dict(
        root=str(args.root), card=smi, loadavg=os.getloadavg(),
        cpus=os.cpu_count(), steps=steps, final_acc=acc,
        engine_ms_per_round=per_round,
        engine_ms_per_round_median=statistics.median(per_round),
        engine_host_ms_per_round=[v / steps for v in eng_host],
        train_step_ms=ts_dev, train_step_ms_median=statistics.median(ts_dev),
        train_step_host_ms=ts_host,
        device_grads_ms_median=statistics.median(dg_dev))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
