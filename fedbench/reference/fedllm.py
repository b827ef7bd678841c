"""Plain reference of the streamed federated round over a decoder model,
and the readings the benchmark compares.

A round ``t``: each of ``m`` devices draws ``batch`` x ``seq_len`` tokens
from the round's key and takes the gradient of its loss; the flat
gradients (parameters in sorted-key order, zero-padded to whole chunks)
are cut into chunks of ``chunk_len`` entries, and each chunk is one A-DSGD
round over the MAC with its own key; the PS concatenates the decoded
chunks into ĝ and takes an Adam step.  The error state persists per chunk
and device across rounds.

Keys: the round key is ``PRNGKey(1000 + seed * key_rounds + t)``; the data
key ``fold_in(key, 9)``, split one per device; chunk ``i``'s key
``fold_in(fold_in(key, 8), i)``, whose ``fold_in(., 0)`` draws the AWGN.

Everything is worked out again from the seed and the settings; the
reference takes no tensor from the program.  ``fault`` plants one of the
faults the comparison must catch: ``"half_batch"`` (each device's loss
over half its sequences), ``"token"`` (one token of device 0's batch
altered where it is drawn).
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from fedbench.reference import ota, rng
from fedbench.reference import transformer as tfm

SALT_STREAM, SALT_DATA, KEY_BASE = 8, 9, 1000
#: what the reference implements of the scheme and the optimizer; a cell
#: asking for anything else is refused
SUPPORTED = (("train", "optimizer", "adam"), ("train", "weight_decay", 0.0),
             ("train", "grad_clip", 0.0), ("ota", "scheme", "a_dsgd"),
             ("ota", "projection", "blocked"), ("ota", "rademacher", True),
             ("ota", "power_schedule", "constant"), ("ota", "fading", "none"),
             ("ota", "geometry", "none"), ("ota", "state_dtype", "float32"),
             ("ota", "robust", False))


@dataclasses.dataclass(frozen=True)
class Settings:
    """One cell's round: model, devices, tokens, chunks, scheme, Adam."""
    arch: tfm.Arch
    m: int
    batch: int
    seq_len: int
    chunk_len: int
    key_rounds: int
    block_size: int
    s_frac: float
    k_frac: float
    p_avg: float
    sigma2: float
    amp_iters: int
    mean_removal_steps: int
    ota_seed: int
    lr: float
    warmup_steps: int
    total_steps: int
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    compute_dtype: str = "bfloat16"

    @classmethod
    def from_files(cls, config: dict, workload: dict) -> "Settings":
        t, o, r = workload["train"], workload["ota"], workload["round"]
        for group, key, value in SUPPORTED:
            got = {"train": t, "ota": o}[group].get(key, value)
            if got != value:
                raise ValueError(f"the reference runs {group}.{key} = "
                                 f"{value!r}, the cell asks for {got!r}")
        return cls(arch=tfm.Arch.from_config(config), m=r["m"],
                   batch=r["batch"], seq_len=r["seq_len"],
                   chunk_len=r["chunk_len"], key_rounds=r["key_rounds"],
                   block_size=o["block_size"], s_frac=o["s_frac"],
                   k_frac=o["k_frac"], p_avg=o["p_avg"], sigma2=o["sigma2"],
                   amp_iters=o["amp_iters"],
                   mean_removal_steps=o["mean_removal_steps"],
                   ota_seed=o["seed"],
                   lr=t["lr"], warmup_steps=t["warmup_steps"],
                   total_steps=t["total_steps"],
                   compute_dtype=t["compute_dtype"])

    @property
    def s_block(self) -> int:
        return max(2, int(round(self.s_frac * self.block_size)))


def round_key(seed: int, t: int, key_rounds: int, device) -> torch.Tensor:
    return torch.tensor([0, (KEY_BASE + seed * key_rounds + t) & rng.MASK32],
                        dtype=torch.int64, device=device)


def lr_at(cfg: Settings, count: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine decay to 0 at ``total_steps``."""
    step = count.to(torch.float32)
    lr = torch.full_like(step, cfg.lr)
    if cfg.warmup_steps > 0:
        lr = lr * torch.clamp(rng.div_f32(step, cfg.warmup_steps), max=1.0)
    if cfg.total_steps > 0:
        span = max(cfg.total_steps - cfg.warmup_steps, 1)
        frac = torch.clamp(rng.div_f32(step - cfg.warmup_steps, span), 0.0, 1.0)
        lr = lr * (0.5 * (1.0 + torch.cos(math.pi * frac)))
    return lr


def adam(cfg: Settings, params, ghat, state):
    """One Adam step with bias correction; returns new params and state."""
    count = state["count"] + 1
    lr = lr_at(cfg, state["count"])
    b1, b2 = cfg.b1, cfg.b2
    m = tfm.tree_map(lambda g, m_: b1 * m_ + (1 - b1) * g, ghat, state["m"])
    v = tfm.tree_map(lambda g, v_: b2 * v_ + (1 - b2) * g * g, ghat,
                     state["v"])
    c = count.to(torch.float32)
    mhat_s, vhat_s = 1.0 / (1 - b1 ** c), 1.0 / (1 - b2 ** c)

    def update(p, m_, v_):
        step = m_ * mhat_s / (torch.sqrt(v_ * vhat_s) + cfg.eps)
        return p - lr * (step + 0.0 * p)
    return (tfm.tree_map(update, params, m, v),
            {"m": m, "v": v, "count": count})


def device_tokens(cfg: Settings, key: torch.Tensor,
                  fault: Optional[str] = None) -> List[torch.Tensor]:
    """Each device's tokens of the round with key ``key``."""
    keys = rng.split(rng.fold_in(key, SALT_DATA), cfg.m)
    out = [rng.randint(keys[i], (cfg.batch, cfg.seq_len), 0, cfg.arch.vocab)
           for i in range(cfg.m)]
    if fault == "half_batch":
        out = [t[: max(1, cfg.batch // 2)] for t in out]
    elif fault == "token":
        out[0] = out[0].clone()
        out[0][0, cfg.seq_len // 2] = (out[0][0, cfg.seq_len // 2] + 1) \
            % cfg.arch.vocab
    return out


class Round:
    """The reference's state across rounds and one round's arithmetic."""

    def __init__(self, cfg: Settings, seed: int, device,
                 precision: str = "float64", fault: Optional[str] = None):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.precision, self.fault = precision, fault
        self.params = tfm.init_params(cfg.arch, seed, self.device)
        self.d = sum(t.numel() for t in tfm.leaves(self.params))
        self.n_chunks = -(-self.d // cfg.chunk_len)
        self.d_pad = self.n_chunks * cfg.chunk_len
        self.blocks = cfg.chunk_len // cfg.block_size
        zeros = lambda: tfm.tree_map(torch.zeros_like, self.params)  # noqa
        self.state = {"m": zeros(), "v": zeros(),
                      "count": torch.zeros((), dtype=torch.int32,
                                           device=self.device)}
        self.deltas = torch.zeros((self.n_chunks, cfg.m, cfg.chunk_len),
                                  device=self.device)
        self.k = max(1, int(cfg.k_frac * self.blocks * cfg.s_block))

    def gradients(self, key):
        """(m, d_pad) flat gradients and the devices' mean loss."""
        cfg = self.cfg
        gflat = torch.zeros((cfg.m, self.d_pad), device=self.device)
        dt = getattr(torch, cfg.compute_dtype)
        losses = [tfm.grads(self.params, cfg.arch, tok, gflat[i, :self.d],
                            dt)
                  for i, tok in enumerate(device_tokens(cfg, key,
                                                        self.fault))]
        return gflat, torch.stack(losses).mean()

    def _a(self, g0: int, n: int) -> torch.Tensor:
        cfg = self.cfg
        return ota.block_matrices(cfg.ota_seed, g0, n, cfg.s_block,
                                  cfg.block_size, self.device)

    def aggregate(self, gflat: torch.Tensor, t: int, key) -> torch.Tensor:
        """ĝ (d_pad,) of one round; updates the error state."""
        cfg, nb, L = self.cfg, self.blocks, self.cfg.chunk_len
        m, s, c, nch = cfg.m, cfg.s_block, cfg.block_size, self.n_chunks
        for i in range(nch):                     # devices' sparsifiers
            sl = slice(i * L, (i + 1) * L)
            sp, self.deltas[i] = ota.sparsify(gflat[:, sl].contiguous(),
                                              self.deltas[i], self.k)
            gflat[:, sl] = sp
        # the projections of every chunk and device, a group of blocks at
        # a time: (chunks, m, blocks, s)
        proj = torch.empty((nch, m, nb, s), device=self.device)
        xb = gflat.view(m, nch, nb, c)
        for g0 in range(0, nb, ota.BLOCK_GROUP):
            n = min(ota.BLOCK_GROUP, nb - g0)
            x = xb[:, :, g0:g0 + n].permute(2, 1, 0, 3).reshape(n, nch * m, c)
            y = ota.product(x, self._a(g0, n), self.precision, transpose=True)
            proj[:, :, g0:g0 + n] = y.view(n, nch, m, s).permute(1, 2, 0, 3)
        del xb
        p_t = torch.full((m,), float(np.float32(cfg.p_avg)),
                         device=self.device)
        mr = t < cfg.mean_removal_steps
        obs = torch.empty((nch, nb, s), device=self.device)
        stream = rng.fold_in(key, SALT_STREAM)
        for i0 in range(0, nch, ota.NOISE_GROUP):   # frames, the MAC, the PS
            ids = torch.arange(i0, min(i0 + ota.NOISE_GROUP, nch),
                               device=self.device)
            z = ota.noise(rng.fold_in(rng.fold_in(stream, ids), 0),
                          nb * s + 2, cfg.sigma2)
            for j, i in enumerate(ids.tolist()):
                fr = ota.frame(proj[i].reshape(m, nb * s), p_t, mr)
                obs[i] = ota.receive(fr, z[j], mr).view(nb, s)
        del proj
        ghat = torch.empty((nch, nb, c), device=self.device)
        for g0 in range(0, nb, ota.BLOCK_GROUP):  # AMP, all chunks at once
            n = min(ota.BLOCK_GROUP, nb - g0)
            y = obs[:, g0:g0 + n].permute(1, 0, 2).contiguous()
            ghat[:, g0:g0 + n] = ota.amp(y, self._a(g0, n), cfg.amp_iters,
                                         self.precision).permute(1, 0, 2)
        return ghat.reshape(self.d_pad)

    def step(self, t: int) -> float:
        """Round ``t``; returns the devices' mean loss."""
        cfg = self.cfg
        key = round_key(self.seed, t, cfg.key_rounds, self.device)
        gflat, loss = self.gradients(key)
        ghat = self.aggregate(gflat, t, key)
        del gflat
        tree = tfm.unflatten(ghat[: self.d], self.params)
        self.params, self.state = adam(cfg, self.params, tree, self.state)
        return float(loss)


def norms(tree) -> Dict[str, float]:
    """Each leaf's 2-norm, summed in float64."""
    return {n: float(torch.linalg.vector_norm(t, dtype=torch.float64))
            for n, t in zip(tfm.leaf_names(tree), tfm.leaves(tree))}


def host_copy(tree):
    return tfm.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def change_norms(tree, before) -> Dict[str, float]:
    """Each leaf's ``||now - before||``, ``before`` a host copy."""
    out = {}
    for n, now, old in zip(tfm.leaf_names(tree), tfm.leaves(tree),
                           tfm.leaves(before)):
        diff = now.detach() - old.to(now.device)
        out[n] = float(torch.linalg.vector_norm(diff, dtype=torch.float64))
    return out


def grad_norms(first_moment, b1: float = 0.9) -> Dict[str, float]:
    """The first step's ĝ per leaf, as Adam's first moment holds it after
    that step (``m = (1 - b1) ĝ``)."""
    return {n: v / (1 - b1) for n, v in norms(first_moment).items()}


def run(cfg: Settings, seed: int, rounds: int, device,
        precision: str = "float64", fault: Optional[str] = None) -> dict:
    """``rounds`` rounds from the seed.  The readings: each step's loss,
    the first step's ĝ per leaf, and each leaf's change over the steps."""
    r = Round(cfg, seed, device, precision, fault)
    start = host_copy(r.params)
    losses, grad = [], None
    for t in range(rounds):
        losses.append(r.step(t))
        if t == 0:
            grad = grad_norms(r.state["m"], cfg.b1)
    return {"losses": losses, "grad": grad,
            "change": change_norms(r.params, start)}


def compare(got: dict, ref: dict, floor: float = 1e-3) -> dict:
    """The gaps between a run's readings and the reference's.

    ``loss_gap``: the largest relative gap of a step's loss.  ``grad_gap``
    and ``change_gap``: by the worst leaf, ``|n_got - n_ref|`` over the
    larger of the reference's norm of that leaf and of the median leaf.
    Leaves whose reference gradient is under ``floor`` times the median
    leaf's move by round-off alone and are left out of ``change_gap``.
    Also the leaves that set the two gaps.
    """
    def finite(x):
        return x if math.isfinite(x) else math.inf

    if len(got["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    else:
        loss_gap = max(finite(abs(a - b) / abs(b))
                       for a, b in zip(got["losses"], ref["losses"]))

    def by_leaf(key, leaves):
        med = statistics.median(ref[key][n] for n in ref[key])
        gaps = {n: finite(abs(got[key][n] - ref[key][n])
                          / max(ref[key][n], med)) for n in leaves}
        worst = max(gaps, key=lambda n: gaps[n])
        return gaps[worst], worst

    g_med = statistics.median(ref["grad"].values())
    moved = [n for n in ref["grad"] if ref["grad"][n] >= floor * g_med]
    grad_gap, grad_leaf = by_leaf("grad", list(ref["grad"]))
    change_gap, change_leaf = by_leaf("change", moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_leaf": grad_leaf,
            "change_leaf": change_leaf,
            "left_out": sorted(set(ref["grad"]) - set(moved))}
