"""Driver of the port's streamed federated round:
``repro_torch.train.fedllm.CompiledFedLLM.run_segment``, one round a call.

Set-up builds one ``CompiledFedLLM`` from the cell's files and the seed
(its weights drawn on the card), and drives it through its first
``check_rounds`` rounds by the same call the window makes.  Those rounds
compile and warm every shape, and give the readings the reference is held
against: each round's loss, the first round's ĝ per leaf (from Adam's first
moment after it) and each leaf's change over the rounds.  The same object
then runs the window.  Round ``t``'s key is ``round_keys(key_rounds,
seed)[t]``.

A traced window is one round under the profiler, with spans from this
file around the round's three phases: the devices' gradients
(``CompiledFedLLM._grads``), the streamed aggregation
(``fedllm.stream_round``) and the PS's Adam step.  The program runs
unchanged; only its attributes are wrapped while the window runs.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import torch

from fedbench.reference import fedllm as ref


def port_arch(config: dict):
    """The port's ``ArchConfig`` from a configuration file's keys."""
    from repro_torch.configs.base import ArchConfig, MoEConfig

    experts = config.get("num_local_experts", 0)
    heads = config["num_attention_heads"]
    return ArchConfig(
        name=config["name"], family="moe" if experts else "dense",
        n_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
        n_heads=heads, n_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"], vocab=config["vocab_size"],
        head_dim=config.get("head_dim", config["hidden_size"] // heads),
        tie_embeddings=config["tie_word_embeddings"],
        norm_eps=config["rms_norm_eps"],
        rope_theta=float(config["rope_theta"]),
        moe=(MoEConfig(num_experts=experts,
                       top_k=config["num_experts_per_tok"],
                       d_expert=config["intermediate_size"])
             if experts else None))


class _Spans:
    """CUDA-event spans, each also a ``record_function`` range."""

    def __init__(self):
        self.events: List[tuple] = []

    def wrap(self, name: str, fn):
        def spanned(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function("fedbench." + name):
                start.record()
                out = fn(*args, **kwargs)
                end.record()
            self.events.append((name, start, end))
            return out
        return spanned

    def ms(self) -> Dict[str, List[float]]:
        torch.cuda.synchronize()
        out: Dict[str, List[float]] = {}
        for name, s, e in self.events:
            out.setdefault(name, []).append(s.elapsed_time(e))
        return out


class _Opt:
    """The optimizer with its ``apply`` spanned."""

    def __init__(self, opt, spans: _Spans):
        self._opt = opt
        self.apply = spans.wrap("adam", opt.apply)


class Cell:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        from repro_torch.configs.base import OTAConfig, TrainConfig
        from repro_torch.experiments.engine import round_keys
        from repro_torch.train import fedllm

        self.config, self.workload, self.seed = config, workload, seed
        r = workload["round"]
        self.fed = fedllm.CompiledFedLLM(
            port_arch(config), TrainConfig(**workload["train"]),
            OTAConfig(**workload["ota"]), m=r["m"], batch=r["batch"],
            seq_len=r["seq_len"], chunk_size=r["chunk_len"], seed=seed,
            device=device)
        want = r["expect"]
        got = {"d": self.fed.d, "n_chunks": self.fed.n_chunks,
               "chunk_len": self.fed.chunk_len}
        if got != want:
            raise ValueError(f"the cell's round is {got}, its file says "
                             f"{want}")
        self.keys = round_keys(r["key_rounds"], seed, device=self.fed.device)
        self.sync = (torch.cuda.synchronize if self.fed.device.type == "cuda"
                     else lambda: None)
        self.carry = None
        self.t = 0

    # ------------------------------------------------------------ set-up
    def setup(self) -> dict:
        """The first rounds, and what the reference is held against.  The
        parameters before and after them go to host memory: their change
        is taken in :meth:`check`, so the window starts on the allocator
        the rounds left."""
        from repro_torch.kernels import build

        if self.fed.device.type == "cuda":
            build.library()       # the kernels' nvcc build, first run only
        self.carry = self.fed.carry0()
        self.start = ref.host_copy(self.carry[0])
        losses, grad, ends = [], None, []
        t0 = time.perf_counter()
        for _ in range(self.workload["round"]["check_rounds"]):
            losses.append(float(self._round()["loss"][0]))
            ends.append(time.perf_counter() - t0)
            if self.t == 1:
                grad = ref.grad_norms(self.carry[1]["m"])
        self.end = ref.host_copy(self.carry[0])
        gc.collect()
        self.sync()
        return {"losses": losses, "grad": grad, "change": None,
                "round_s": [b - a for a, b in zip([0.0] + ends, ends)]}

    def _round(self):
        t = self.t
        if t >= self.keys.shape[0]:
            raise RuntimeError(f"round {t} is past the cell's "
                               f"{self.keys.shape[0]} round keys")
        self.carry, out = self.fed.run_segment({}, self.keys[t:t + 1], None,
                                               self.carry, t)
        self.t += 1
        return out

    # ------------------------------------------------------------ window
    def measure(self, seconds: float) -> dict:
        """Whole rounds until the first that ends at or after ``seconds``;
        ``round_ms`` is the window over the rounds, on the host's clock."""
        from repro_torch.kernels import ops

        losses, launches, ends = [], [], []
        self.sync()
        t0 = time.perf_counter()
        while True:
            ops.reset_launches()
            losses.append(self._round()["loss"][0])
            self.sync()
            ends.append(time.perf_counter() - t0)
            launches.append(ops.launch_counts())
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
                         "launches": launches}}

    def trace(self, path):
        """Two rounds with the phases' spans: the first on CUDA events
        alone (the spans' times and the round's, which the profiler would
        slow where the host paces the device), the second also under the
        profiler (the device's kernels, busy time and idle gaps)."""
        from fedbench import trace as tr
        from repro_torch.train import fedllm

        spans = _Spans()
        fed = self.fed
        stream = fedllm.stream_round
        fed._grads = spans.wrap("grads", fed._grads)
        fed.opt = _Opt(fed.opt, spans)
        fedllm.stream_round = spans.wrap("aggregate", stream)

        def synced_round():
            out = self._round()
            self.sync()
            return out
        try:
            self.sync()
            t0 = time.perf_counter()
            losses = [synced_round()["loss"][0]]
            round_s = time.perf_counter() - t0
            timed = spans.ms()
            spans.events.clear()
            t1 = time.perf_counter()
            out, kernels, ops, notes = tr.capture(
                spans.wrap("round", synced_round), path)
            capture_s = time.perf_counter() - t1
            losses.append(out["loss"][0])
        finally:
            del fed._grads
            fed.opt = fed.opt._opt
            fedllm.stream_round = stream
        return tr.Trace(rounds=1, kernels=kernels, ops=ops,
                        annotations=notes, spans=timed, round_s=round_s,
                        shapes=self.shapes(), config=self.config,
                        losses=[float(x) for x in losses],
                        capture_s=capture_s)

    def shapes(self) -> dict:
        fed, r = self.fed, self.workload["round"]
        proj = fed.scheme.projector
        return {"m": fed.m, "batch": r["batch"], "seq_len": r["seq_len"],
                "d": fed.d, "n_chunks": fed.n_chunks,
                "blocks": proj.n_blocks, "c": proj.block_size,
                "s": proj.s_block, "iters": fed.ota.amp_iters}

    # ------------------------------------------------------------- check
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.carry = self.fed = self.keys = None
        gc.collect()
        torch.cuda.empty_cache()

    def check(self, got: dict, device) -> dict:
        """The reference's run from the seed, and the gaps to ``got``."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        got["change"] = ref.change_norms(
            ref.tfm.tree_map(lambda t: t.to(device), self.end), self.start)
        self.start = self.end = None
        settings = ref.Settings.from_files(self.config, self.workload)
        want = ref.run(settings, self.seed, len(got["losses"]), device)
        return {"gaps": ref.compare(got, want),
                "reference_losses": want["losses"],
                "leaves": len(want["grad"])}
