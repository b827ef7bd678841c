"""Driver of the port's sharded trainer: the flat-layout step of
``repro_torch.train.trainer.make_train_step`` on a mesh of rank threads
``(data, model)`` on one card, one step a call.

    python3 fedbench/run.py --workload smollm_360m.train_step \\
        --seed <n> --seconds <s> --trace <0|1>

The workload's ``round`` gives the mesh (``[devices, shards]``: one OTA
device a ``data`` coordinate, the flat gradient sliced over ``model``),
the global batch (``batch`` x ``seq_len`` tokens a step, split in order
over the devices), the key stream, the sizes the step must report and
``shard_decode`` (the PS's decode split over the device rows); ``ota`` and
``train`` are the other fields of ``OTAConfig`` and ``TrainConfig``.  Step
``t``'s key is ``round_keys(key_rounds, seed)[t]`` and its tokens
``randint(fold_in(key, 9), (batch, seq_len), 0, vocab)``.

Set-up builds the step and its state from the seed (weights drawn on the
card) and runs the first ``check_rounds`` steps, which warm every shape
and give the readings: each step's ``global_loss``, the first step's ĝ per
leaf (Adam's first moment after it) and each leaf's change.  The window
runs whole steps until the first that ends at or after ``seconds``;
``round_ms`` is the window over them.  A traced window is one step with
the port's tracer (``repro_torch.tracing``) armed, whose ``round`` span
holds ``step.grads`` (phase 1) and ``step.aggregate`` (phase 2): their
device ms go to the trace's ``spans``; then one step, disarmed, under the
profiler.  The check runs :mod:`fedbench.reference.train_step` from the
seed.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Optional

import torch

from fedbench import trace as tr
from fedbench.drivers import fedllm_round as base
from fedbench.drivers.fedllm_hybrid_round import tracer_spans
from fedbench.reference import fedllm as ref
from fedbench.reference import train_step as ref_step


def reference(config: dict, workload: dict, seed: int, rounds: int, device,
              precision: str = "float64",
              fault: Optional[str] = None) -> dict:
    """The reference's readings over ``rounds`` steps from the seed."""
    return ref_step.run(ref_step.Settings.from_files(config, workload), seed,
                        rounds, device, precision, fault)


class Cell:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        from repro_torch.configs.base import OTAConfig, TrainConfig
        from repro_torch.experiments.engine import round_keys
        from repro_torch.sharding import Mesh
        from repro_torch.train.trainer import make_train_step

        self.config, self.workload, self.seed = config, workload, seed
        r = workload["round"]
        self.ts = make_train_step(
            base.port_arch(config), TrainConfig(**workload["train"]),
            dataclasses.replace(OTAConfig(**workload["ota"]),
                                shard_decode=r["shard_decode"]),
            Mesh(tuple(r["mesh"]), ("data", "model")), ota_axes=("data",),
            device=device)
        got = {"d": self.ts.d, "d_pad": self.ts.d_pad,
               "m_devices": self.ts.m_devices}
        if got != r["expect"]:
            raise ValueError(f"the cell's step is {got}, its file says "
                             f"{r['expect']}")
        self.device = self.ts.device
        self.keys = round_keys(r["key_rounds"], seed, device=self.device)
        self.sync = (torch.cuda.synchronize if self.device.type == "cuda"
                     else lambda: None)
        self.state = None
        self.t = 0

    # ------------------------------------------------------------ set-up
    def setup(self) -> dict:
        from repro_torch import rng
        from repro_torch.kernels import build

        if self.device.type == "cuda":
            build.library()       # the kernels' nvcc build, first run only
        self.state = self.ts.init_state(rng.PRNGKey(self.seed,
                                                    device=self.device))
        self.start = ref.host_copy(self.state[0])
        losses, grad, ends = [], None, []
        t0 = time.perf_counter()
        for _ in range(self.workload["round"]["check_rounds"]):
            losses.append(float(self._step()["global_loss"]))
            ends.append(time.perf_counter() - t0)
            if self.t == 1:
                grad = ref.grad_norms(self.state[1]["m"])
        self.end = ref.host_copy(self.state[0])
        gc.collect()
        self.sync()
        return {"losses": losses, "grad": grad, "change": None,
                "round_s": [b - a for a, b in zip([0.0] + ends, ends)]}

    def batch(self, key) -> dict:
        from repro_torch import rng

        r = self.workload["round"]
        return {"tokens": rng.randint(rng.fold_in(key, ref.SALT_DATA),
                                      (r["batch"], r["seq_len"]), 0,
                                      self.ts.arch.vocab)}

    def _step(self):
        t = self.t
        if t >= self.keys.shape[0]:
            raise RuntimeError(f"step {t} is past the cell's "
                               f"{self.keys.shape[0]} round keys")
        key = self.keys[t]
        batch = self.batch(key)
        params, opt_state, delta = self.state
        params, opt_state, delta, met = self.ts.jitted(batch)(
            params, opt_state, delta, batch, t, key)
        self.state = (params, opt_state, delta)
        self.t += 1
        return met

    # ------------------------------------------------------------ window
    def measure(self, seconds: float) -> dict:
        """Whole steps until the first that ends at or after ``seconds``;
        ``round_ms`` is the window over the steps, on the host's clock."""
        from repro_torch.kernels import ops

        losses, launches, ends, splits = [], [], [], []
        self.sync()
        t0 = time.perf_counter()
        while True:
            ops.reset_launches()
            losses.append(self._step()["global_loss"])
            self.sync()
            ends.append(time.perf_counter() - t0)
            launches.append(ops.launch_counts())
            splits.append(dict(self.ts.split))
            if ends[-1] >= seconds:
                break
        window = ends[-1]
        values = [float(x) for x in losses]
        return {"round_ms": window * 1e3 / len(values),
                "attempted": len(values),
                "failed": sum(not math.isfinite(x) for x in values),
                "info": {"window_s": window, "losses": values,
                         "round_s": [b - a for a, b in zip([0.0] + ends,
                                                           ends)],
                         "launches": launches, "split_s": splits}}

    def trace(self, path):
        """One step with the port's tracer armed (its spans' device times
        and the step's host time), then one under the profiler."""
        from repro_torch import tracing

        def synced_step():
            out = self._step()
            self.sync()
            return out
        tracing.clear()
        tracing.enable()
        try:
            self.sync()
            t0 = time.perf_counter()
            losses = [synced_step()["global_loss"]]
            round_s = time.perf_counter() - t0
        finally:
            tracing.disable()
        spans = tracer_spans(tracing.last_round())
        tracing.clear()

        def profiled():
            with torch.profiler.record_function(tr.SPAN_PREFIX + "round"):
                return synced_step()
        t1 = time.perf_counter()
        out, kernels, ops, notes = tr.capture(profiled, path)
        capture_s = time.perf_counter() - t1
        losses.append(out["global_loss"])
        return tr.Trace(rounds=1, kernels=kernels, ops=ops,
                        annotations=notes, spans=spans, round_s=round_s,
                        shapes=self.shapes(), config=self.config,
                        losses=[float(x) for x in losses],
                        capture_s=capture_s)

    def shapes(self) -> dict:
        r, ota = self.workload["round"], self.ts.ota
        c = ota.block_size
        return {"mesh": list(r["mesh"]), "m": self.ts.m_devices,
                "batch": r["batch"], "seq_len": r["seq_len"],
                "d": self.ts.d, "d_pad": self.ts.d_pad,
                "blocks": self.ts.d_pad // c, "c": c,
                "s": max(2, int(round(ota.s_frac * c))),
                "iters": ota.amp_iters}

    # ------------------------------------------------------------- check
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.state = self.ts = self.keys = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, got: dict, device) -> dict:
        """The reference's steps from the seed, and the gaps to ``got``."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        got["change"] = ref.change_norms(
            ref.tfm.tree_map(lambda t: t.to(device), self.end), self.start)
        self.start = self.end = None
        want = reference(self.config, self.workload, self.seed,
                         len(got["losses"]), device)
        return {"gaps": ref.compare(got, want),
                "reference_losses": want["losses"],
                "leaves": len(want["grad"])}
