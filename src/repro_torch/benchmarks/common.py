"""Shared harness for the paper-figure benchmarks (§VI), on the port.

The port of the reference's ``benchmarks/common.py``.  Every figure prints
CSV rows ``figure,series,step,test_accuracy`` and collects summary triples
``(name, us_per_call, final_acc)`` for :mod:`repro_torch.benchmarks.run`.
Figure grids run through :func:`repro_torch.experiments.run_sweep` (one
batched round per step for a static group's points, :func:`sweep_series`);
:func:`run_series` keeps the looped ``run_federated`` path for timing
comparisons (:mod:`repro_torch.benchmarks.bench_sweeps`).

Scale: the default is the reference's reduced rendition (the paper's
d = 7850 single-layer model, fewer devices and rounds); ``FULL=1`` in the
environment restores the paper's M = 25, B = 1000, T = 300.  MNIST is
replaced by the deterministic surrogate, so claims hold in relative terms.

On the card every clock read follows a ``torch.cuda.synchronize()``: torch
returns before the device finishes, and the host's clock alone would time
the enqueue.
"""
from __future__ import annotations

import os
import subprocess
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import OTAConfig
from repro_torch.core.schemes import PAPER_SCHEMES, SCHEME_REGISTRY  # noqa: F401
from repro_torch.data.synthetic import federated_split, make_classification
from repro_torch.device import clock, resolve_device
from repro_torch.train.paper_repro import run_federated

FULL = bool(int(os.environ.get("FULL", "0")))

#: the checkout's root, where the timing scripts write ``BENCH_torch_*.json``
REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                         "..", ".."))


@dataclass
class Scale:
    m: int = 25 if FULL else 10
    b: int = 1000 if FULL else 400
    n_train: int = 60000 if FULL else 8000
    n_test: int = 10000 if FULL else 2000
    steps: int = 300 if FULL else 30
    amp_iters: int = 25 if FULL else 12
    eval_every: int = 10 if FULL else 5
    noise: float = 6.0          # surrogate difficulty: schemes separate
    lr: float = 1e-3


SCALE = Scale()


def device_info(device) -> Dict[str, Optional[str]]:
    """The device's name and power limit, as every record of a time
    carries them: ``nvidia-smi``'s ``power.limit`` for a card, ``None``
    for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return {"device": torch.cuda.get_device_name(index),
            "power_limit": out.stdout.strip()}


def dataset(iid: bool = True, m: Optional[int] = None,
            b: Optional[int] = None, seed: int = 3,
            partition: str = "", beta: float = 1.0):
    """Surrogate dataset split over M devices (host numpy arrays).

    ``partition`` selects any :mod:`repro_torch.data.partition` kind
    (``iid`` | ``label_shards`` | ``dirichlet`` with bias knob ``beta``);
    empty keeps the paper's two protocols via ``iid``.
    """
    m = m or SCALE.m
    b = b or SCALE.b
    (xtr, ytr), (xte, yte) = make_classification(
        n_train=SCALE.n_train, n_test=SCALE.n_test, noise=SCALE.noise,
        seed=seed)
    xd, yd = federated_split(xtr, ytr, m=m, b=b, iid=iid, seed=0,
                             kind=partition, beta=beta)
    return (xd, yd), (xte, yte)


def ota(scheme: str, **kw) -> OTAConfig:
    """Figure-scale OTAConfig for a registered scheme name."""
    if scheme not in SCHEME_REGISTRY:
        raise KeyError(f"unknown scheme {scheme!r}; registered: "
                       f"{', '.join(sorted(SCHEME_REGISTRY))}")
    base = dict(scheme=scheme, s_frac=0.5, p_avg=500.0,
                total_steps=SCALE.steps, projection="dense",
                amp_iters=SCALE.amp_iters, mean_removal_steps=min(
                    20, SCALE.steps // 3),
                # k = s/4 recovers better than the paper's k = s/2 at the
                # reduced M (union-support pressure on AMP); FULL keeps s/2
                k_frac=0.5 if FULL else 0.25)
    base.update(kw)
    return OTAConfig(**base)


def _rows(fig: str, series: str, accs, steps: int, rows: List[str]) -> None:
    for i, acc in enumerate(accs):
        step = min(i * SCALE.eval_every, steps - 1)
        rows.append(f"{fig},{series},{step},{acc:.4f}")


def run_series(fig: str, series: str, dev_data, test_data, cfg: OTAConfig,
               steps: Optional[int] = None, lr: Optional[float] = None,
               rows: Optional[List[str]] = None, device=None) -> Dict:
    """One looped ``run_federated`` run: its rows, final accuracy and host
    microseconds per round."""
    (xd, yd), (xte, yte) = dev_data, test_data
    dev = resolve_device(device)
    steps = steps or SCALE.steps
    t0 = clock(dev)
    run = run_federated(xd, yd, xte, yte, cfg, steps=steps,
                        lr=lr or SCALE.lr, eval_every=SCALE.eval_every,
                        device=dev)
    dt = clock(dev) - t0
    out_rows = rows if rows is not None else []
    _rows(fig, series, run.accs, steps, out_rows)
    return {"final_acc": run.accs[-1], "us_per_call": dt / steps * 1e6,
            "rows": out_rows, "run": run}


def sweep_series(fig: str, dev_data, test_data, axes: Dict[str, Sequence],
                 series_fn: Callable[[Dict], str],
                 rows: Optional[List[str]] = None,
                 steps: Optional[int] = None, lr: Optional[float] = None,
                 device=None, **ota_kw) -> Tuple[object, List]:
    """Run a figure grid through the port's sweep engine.

    ``axes`` follows :func:`repro_torch.experiments.run_sweep` (batched:
    ``p_avg`` / ``power_schedule`` / ``seed`` / ``m_active`` and the
    scalar axes; static: any OTAConfig field, e.g. ``scheme`` /
    ``s_frac``); ``ota_kw`` fills the base OTAConfig via :func:`ota`.
    Emits the same ``figure,series,step,acc`` rows and ``(name,
    us_per_call, final_acc)`` summary entries as :func:`run_series` --
    ``series_fn(record)`` names each grid point.  Returns (SweepResult,
    summary).
    """
    from repro_torch.experiments import run_sweep
    steps = steps or SCALE.steps
    scheme0 = (axes["scheme"][0] if "scheme" in axes
               else ota_kw.pop("scheme"))
    base = ota(scheme0, total_steps=steps, **ota_kw)
    res = run_sweep(dev_data, test_data, base, axes, steps=steps,
                    lr=lr or SCALE.lr, eval_every=SCALE.eval_every,
                    device=device)
    summary = []
    for rec in res.records:
        series = series_fn(rec)
        if rows is not None:
            _rows(fig, series, rec["accs"], steps, rows)
        summary.append((f"{fig}_{series}", rec["us_per_call"],
                        rec["final_acc"]))
    return res, summary


def seed_mean(records: Sequence[Dict]) -> Tuple[List[float], float]:
    """The seed-averaged accuracies of ``records`` at each eval step, and
    their mean ``us_per_call``, as the reference's gated figures average
    their seed replicas."""
    accs = [rec["accs"] for rec in records]
    mean_accs = [sum(col) / len(col) for col in zip(*accs)]
    us = sum(rec["us_per_call"] for rec in records) / len(records)
    return mean_accs, us


def emit(rows: List[str]) -> None:
    print("figure,series,step,test_accuracy")
    for r in rows:
        print(r)
