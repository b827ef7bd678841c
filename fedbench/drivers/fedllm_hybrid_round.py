"""Driver of the port's streamed federated round on granite-4.0-h's hybrid
decoder: ``repro_torch.train.fedllm.CompiledFedLLM.run_segment``, one round
a call, as :mod:`fedbench.drivers.fedllm_round` drives the dense and MoE
cells.

The configuration's published keys (``layer_types``, the ``mamba_*`` keys,
Granite's multipliers, ``position_embedding_type``) map to the port's
``ArchConfig``: the pattern's Mamba2 layers are ``MAMBA2_MLP`` blocks (the
published Mamba2 mixer, then the SwiGLU MLP), its attention layers
``ATTN`` blocks with NoPE attention.  The check runs the plain reference
of :mod:`fedbench.reference.granite_hybrid` through the round of
:mod:`fedbench.reference.fedllm`, whose model is swapped for the hybrid
one here.  The reference's SSD sums in the program's chunks and order, so
the program equals it bit for bit, and the cell's limits are 0.55 times
the least reading of the reference's TF32 control, as the dense cells'
are.

A traced window is :class:`fedbench.drivers.fedllm_round.Cell`'s: one
round on CUDA events, then one under the profiler.  The port's tracer
(``repro_torch.tracing``) is armed for the first round alone and
disarmed before the profiled one; the device times of its spans in that
round are summed by name into the trace's ``spans``, beside the base
cell's own ``grads`` (the devices' forward and backward, read by
``hybrid_grads_ms``) and ``aggregate``, which keep theirs (``model.mamba``:
each Mamba2 mixer's forward; the backward and remat's recompute run on
autograd's device thread, outside the round's spans, so it is the
forward alone), beside the counters' totals under ``counters.<name>``.

On the card the cell's process maps the caching allocator's segments
expandably (``ALLOCATOR``) before the program allocates.

    python3 fedbench/run.py --workload granite_4_0_h_micro.adsgd_round \\
        --seed <n> --seconds <s> --trace <0|1>
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from fedbench.drivers import fedllm_round as base
from fedbench.reference import fedllm as ref
from fedbench.reference import granite_hybrid as hyb


#: the caching allocator's segments grow in place (PyTorch's
#: ``expandable_segments``): at 2 x 1024 tokens a device the gradients'
#: activations leave ~30 GB of the card reserved in pieces that the
#: stream's 14 GB error-state buffer does not fit
ALLOCATOR = "expandable_segments:True"


def port_arch(config: dict):
    """The port's ``ArchConfig`` from a hybrid configuration file's keys."""
    from repro_torch.configs.base import (
        ATTN, MAMBA2_MLP, ArchConfig, SSMConfig,
    )

    arch = hyb.Arch.from_config(config)
    return ArchConfig(
        name=config["name"], family="hybrid", n_layers=arch.n_layers,
        d_model=arch.d_model, n_heads=arch.n_heads,
        n_kv_heads=arch.n_kv_heads, d_ff=arch.d_ff, vocab=arch.vocab,
        head_dim=arch.head_dim, tie_embeddings=config["tie_word_embeddings"],
        norm_eps=arch.norm_eps,
        block_pattern=tuple(ATTN if k == hyb.ATTN else MAMBA2_MLP
                            for k in arch.kinds()),
        ssm=SSMConfig(d_state=arch.d_state, expand=arch.expand,
                      head_dim=arch.ssm_head_dim, conv_width=arch.conv_width,
                      chunk=config["mamba_chunk_size"], published=True,
                      n_groups=arch.n_groups),
        embedding_multiplier=arch.embedding_multiplier,
        attention_multiplier=arch.attention_multiplier,
        residual_multiplier=arch.residual_multiplier,
        logits_scaling=arch.logits_scaling,
        position_embedding=config["position_embedding_type"])


# ---------------------------------------------------------------------------
# the reference's round on the hybrid model
# ---------------------------------------------------------------------------


def settings(config: dict, workload: dict) -> ref.Settings:
    return dataclasses.replace(ref.Settings.from_files(config, workload),
                               arch=hyb.Arch.from_config(config))


class Round(ref.Round):
    """:class:`fedbench.reference.fedllm.Round` with the hybrid decoder's
    weights and gradients."""

    def __init__(self, cfg: ref.Settings, seed: int, device,
                 precision: str = "float64", fault: Optional[str] = None):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.precision, self.fault = precision, fault
        self.params = hyb.init_params(cfg.arch, seed, self.device)
        self.d = sum(t.numel() for t in hyb.leaves(self.params))
        self.n_chunks = -(-self.d // cfg.chunk_len)
        self.d_pad = self.n_chunks * cfg.chunk_len
        self.blocks = cfg.chunk_len // cfg.block_size
        zeros = lambda: hyb.tree_map(torch.zeros_like, self.params)  # noqa
        self.state = {"m": zeros(), "v": zeros(),
                      "count": torch.zeros((), dtype=torch.int32,
                                           device=self.device)}
        self.deltas = torch.zeros((self.n_chunks, cfg.m, cfg.chunk_len),
                                  device=self.device)
        self.k = max(1, int(cfg.k_frac * self.blocks * cfg.s_block))

    def gradients(self, key):
        cfg = self.cfg
        gflat = torch.zeros((cfg.m, self.d_pad), device=self.device)
        dt = getattr(torch, cfg.compute_dtype)
        losses = [hyb.grads(self.params, cfg.arch, tok, gflat[i, :self.d],
                            dt)
                  for i, tok in enumerate(ref.device_tokens(cfg, key,
                                                            self.fault))]
        return gflat, torch.stack(losses).mean()


def run(cfg: ref.Settings, seed: int, rounds: int, device,
        precision: str = "float64", fault: Optional[str] = None) -> dict:
    """``rounds`` rounds of the reference from the seed: each step's loss,
    the first step's ĝ per leaf and each leaf's change."""
    r = Round(cfg, seed, device, precision, fault)
    start = ref.host_copy(r.params)
    losses, grad = [], None
    for t in range(rounds):
        losses.append(r.step(t))
        if t == 0:
            grad = ref.grad_norms(r.state["m"], cfg.b1)
    return {"losses": losses, "grad": grad,
            "change": ref.change_norms(r.params, start)}


def reference(config: dict, workload: dict, seed: int, rounds: int, device,
              precision: str = "float64",
              fault: Optional[str] = None) -> dict:
    """The reference's readings over ``rounds`` rounds from the seed."""
    return run(settings(config, workload), seed, rounds, device, precision,
               fault)


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------


def tracer_spans(record: Optional[dict]) -> Dict[str, List[float]]:
    """The device ms of a traced round's port spans summed by name, one
    entry a round, and its counters as ``counters.<name>``."""
    if not record:
        return {}
    out: Dict[str, float] = {}
    for s in record["spans"]:
        if s["device_ms"] is not None:
            out[s["name"]] = out.get(s["name"], 0.0) + s["device_ms"]
    for k, v in record["counters"].items():
        out["counters." + k] = float(v)
    return {k: [v] for k, v in out.items()}


class Cell(base.Cell):
    def __init__(self, config: dict, workload: dict, seed: int, device):
        from repro_torch.configs.base import OTAConfig, TrainConfig
        from repro_torch.experiments.engine import round_keys
        from repro_torch.train import fedllm

        self.config, self.workload, self.seed = config, workload, seed
        r = workload["round"]
        if torch.device(device).type == "cuda":
            torch.cuda.memory._set_allocator_settings(ALLOCATOR)
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

    def trace(self, path):
        """The base cell's traced window, the port's tracer armed for its
        unprofiled round alone."""
        from repro_torch import tracing

        plain, calls = self._round, [0]

        def round_once_armed():
            first = calls[0] == 0
            calls[0] += 1
            if first:
                tracing.clear()
                tracing.enable()
            try:
                return plain()
            finally:
                if first:
                    tracing.disable()
        self._round = round_once_armed
        try:
            tr = super().trace(path)
        finally:
            del self._round
        # the base cell's spans (``grads`` and ``aggregate`` on CUDA
        # events) keep their names; the port's add the rest
        for name, ms in tracer_spans(tracing.last_round()).items():
            tr.spans.setdefault(name, ms)
        tracing.clear()
        return tr

    def check(self, got: dict, device) -> dict:
        """The hybrid reference's run from the seed, and the gaps."""
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
