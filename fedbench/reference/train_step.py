"""Plain reference of the sharded trainer's step in the flat layout
(``repro_torch.train.trainer.make_train_step`` with ``ota_axes=("data",)``
on a ``(devices, shards)`` mesh), and the readings the benchmark compares.

A step ``t``: the round key is ``PRNGKey(1000 + seed * key_rounds + t)``;
the global batch of ``batch`` x ``seq_len`` tokens is drawn from
``fold_in(key, 9)`` and split in order over the ``m`` OTA devices, each
taking the gradient of its local mean loss (``global_loss``: the devices'
losses summed in device order, times ``f32(1 / m)``).  The flat gradient
(parameters in sorted-key order) is zero-padded to a multiple of
``block_size * shards`` and cut into ``shards`` slices, each aggregated on
its own, as each rank of the mesh aggregates its slice:

* the threshold from a strided sample of each device's ``|g + delta|``
  (``sample_per_shard`` entries a slice), the slices' samples gathered in
  shard order, the linear quantile at ``1 - k / d_pad`` with ``k =
  int(k_frac s_frac d_pad)``; error feedback and sparsification against it;
* the blocked projection with the shard's seed ``splitmix32(seed ^
  shard)``, its blocks numbered from 0 within the slice;
* the frame's mean and energy summed over the slices (each slice's sums in
  XLA's CPU order, as the port sums them), ``a = P_t / (E - (s~ - 1) mu^2
  + 1)``; the body ``sqrt(a) (g~ - mu)`` and the slots ``sqrt(a) [mu, 1]``;
* the MAC: the devices' frames summed in device order, the body's AWGN
  from ``fold_in(key, shard)``, the slots' from ``fold_in(key, shards +
  7)``; normalisation by the received scale slot;
* AMP per block with the shard's seed (every block decoded alone, so
  splitting the blocks over the device rows, ``shard_decode``, changes no
  bit).

The slices' ĝ, concatenated, take one Adam step.  Everything is worked out
again from the seed and the settings with the plain pieces of
:mod:`fedbench.reference.ota`, :mod:`fedbench.reference.transformer` and
:mod:`fedbench.reference.fedllm`; the reference takes no tensor from the
program.  ``fault``: ``"half_batch"`` (each device's loss over half its
sequences) or ``"token"`` (one token of device 0's batch altered).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fedbench.reference import fedllm as ref
from fedbench.reference import ota, rng
from fedbench.reference import transformer as tfm

#: XLA's CPU reduce window: a longer reduction sums windows of 32 first
XLA_WINDOW = 32


@dataclasses.dataclass(frozen=True)
class Settings:
    """One cell's step: model, mesh, tokens, scheme, Adam."""
    arch: tfm.Arch
    m: int
    shards: int
    batch: int
    seq_len: int
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
    sample_per_shard: int = 4096

    @classmethod
    def from_files(cls, config: dict, workload: dict) -> "Settings":
        t, o, r = workload["train"], workload["ota"], workload["round"]
        for group, key, value in ref.SUPPORTED + (("ota", "layout", "flat"),
                                                  ("ota", "num_groups", 0)):
            got = {"train": t, "ota": o}[group].get(key, value)
            if got != value:
                raise ValueError(f"the reference runs {group}.{key} = "
                                 f"{value!r}, the cell asks for {got!r}")
        m, shards = r["mesh"]
        return cls(arch=tfm.Arch.from_config(config), m=m, shards=shards,
                   batch=r["batch"], seq_len=r["seq_len"],
                   key_rounds=r["key_rounds"], block_size=o["block_size"],
                   s_frac=o["s_frac"], k_frac=o["k_frac"], p_avg=o["p_avg"],
                   sigma2=o["sigma2"], amp_iters=o["amp_iters"],
                   mean_removal_steps=o["mean_removal_steps"],
                   ota_seed=o["seed"], lr=t["lr"],
                   warmup_steps=t["warmup_steps"],
                   total_steps=t["total_steps"],
                   compute_dtype=t["compute_dtype"])

    @property
    def s_block(self) -> int:
        return max(2, int(round(self.s_frac * self.block_size)))


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum of a 1-D ``x`` in XLA's CPU order: one element after
    another, and a length over 32 first in windows of 32 (zero-padded,
    ``pad // 2`` in front), whose partial sums are summed the same way."""
    n = x.shape[0]
    if n > XLA_WINDOW:
        pad = -n % XLA_WINDOW
        x = torch.cat([x.new_zeros(pad // 2), x, x.new_zeros(pad - pad // 2)])
        w = x.view(-1, XLA_WINDOW)
        acc = w[:, 0] + 0.0
        for i in range(1, XLA_WINDOW):
            acc = acc + w[:, i]
        return xla_sum(acc)
    if n == 1:
        return x[0]
    acc = x[0] + 0.0
    for i in range(1, n):
        acc = acc + x[i]
    return acc


def _i32(v: int) -> int:
    """A uint32 constant as the int32 that holds its bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 (``ota.splitmix32``) on int32-held uint32 words, in place
    after the first add: the adds and products wrap mod 2**32 as the uint32
    ones do, and each right shift is masked to a logical one.  Half the
    bytes a pass of ``ota.splitmix32``'s int64 words."""
    x = x + _i32(ota._GOLDEN)
    x ^= (x >> 16) & 0xFFFF
    x *= _i32(ota._M1)
    x ^= (x >> 15) & 0x1FFFF
    x *= _i32(ota._M2)
    x ^= (x >> 15) & 0x1FFFF
    return x


def block_matrices(seed: int, b0: int, n: int, s: int, c: int,
                   device) -> torch.Tensor:
    """``ota.block_matrices`` bit for bit, hashed in int32 words: a sharded
    step makes A once for each of its ``d_pad / c`` blocks twice a step (the
    projection and the decode), so its hash is most of the reference's
    time."""
    blk = torch.arange(b0, b0 + n, dtype=torch.int64, device=device)
    rows = torch.arange(s, dtype=torch.int64, device=device)
    hb = ota.splitmix32((seed & ota.MASK32) ^ blk)
    hr = ota.splitmix32(hb[:, None] ^ rows[None, :])
    cols = torch.arange(c, dtype=torch.int32, device=device)
    h = _mix32(hr.to(torch.int32)[:, :, None] ^ cols[None, None, :])
    scale = float(np.float32(1.0 / np.sqrt(s)))
    # the sign is the top bit: a negative int32
    return torch.where(h < 0, -scale, scale).to(torch.float32)


def shard_seed(seed: int, shard: int) -> int:
    """The shard's projection seed, ``splitmix32(seed ^ shard)``."""
    return int(ota.splitmix32(torch.tensor((seed & ota.MASK32) ^ shard)))


class Step:
    """The reference's state across steps and one step's arithmetic."""

    def __init__(self, cfg: Settings, seed: int, device,
                 precision: str = "float64", fault: Optional[str] = None):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.precision, self.fault = precision, fault
        self.params = tfm.init_params(cfg.arch, seed, self.device)
        self.d = sum(t.numel() for t in tfm.leaves(self.params))
        unit = cfg.block_size * cfg.shards
        self.d_pad = -(-self.d // unit) * unit
        self.d_local = self.d_pad // cfg.shards
        zeros = lambda: tfm.tree_map(torch.zeros_like, self.params)  # noqa
        self.state = {"m": zeros(), "v": zeros(),
                      "count": torch.zeros((), dtype=torch.int32,
                                           device=self.device)}
        self.delta = torch.zeros((cfg.m, self.d_pad), device=self.device)
        self.k = max(1, int(cfg.k_frac * cfg.s_frac * self.d_pad))

    def tokens(self, key):
        """Each OTA device's rows of the step's global batch."""
        cfg = self.cfg
        tok = rng.randint(rng.fold_in(key, ref.SALT_DATA),
                          (cfg.batch, cfg.seq_len), 0, cfg.arch.vocab)
        per = cfg.batch // cfg.m
        out = [tok[i * per:(i + 1) * per] for i in range(cfg.m)]
        if self.fault == "half_batch":
            out = [t[: max(1, per // 2)] for t in out]
        elif self.fault == "token":
            out[0] = out[0].clone()
            out[0][0, cfg.seq_len // 2] = (out[0][0, cfg.seq_len // 2] + 1) \
                % cfg.arch.vocab
        return out

    def gradients(self, key):
        """(m, d_pad) flat gradients and ``global_loss``."""
        cfg = self.cfg
        gflat = torch.zeros((cfg.m, self.d_pad), device=self.device)
        dt = getattr(torch, cfg.compute_dtype)
        losses = [tfm.grads(self.params, cfg.arch, tok, gflat[i, :self.d],
                            dt)
                  for i, tok in enumerate(self.tokens(key))]
        total = losses[0]
        for x in losses[1:]:
            total = total + x
        return gflat, total * float(np.float32(1.0) / np.float32(cfg.m))

    def _a(self, seed: int, g0: int, n: int) -> torch.Tensor:
        """Blocks ``g0 .. g0 + n - 1`` of the shard's A, in float64 for
        the float64 products (made once for all of an AMP's products)."""
        cfg = self.cfg
        a = block_matrices(seed, g0, n, cfg.s_block, cfg.block_size,
                           self.device)
        return a.double() if self.precision == "float64" else a

    def aggregate(self, gflat: torch.Tensor, t: int, key) -> torch.Tensor:
        """ĝ (d_pad,) of one step; updates the error state."""
        cfg, m, c, s = self.cfg, self.cfg.m, self.cfg.block_size, \
            self.cfg.s_block
        L, nb = self.d_local, self.d_local // c
        stride = max(1, L // cfg.sample_per_shard)
        n_s = L // stride
        # the threshold: each device's samples, gathered over the slices
        samples = torch.cat([
            (gflat[:, j * L:(j + 1) * L][:, 0:n_s * stride:stride]
             + self.delta[:, j * L:(j + 1) * L][:, 0:n_s * stride:stride])
            .abs() for j in range(cfg.shards)], dim=-1)
        tau = ota.quantile(samples, 1.0 - self.k / self.d_pad)
        ec = gflat + self.delta
        sp = torch.where(ec.abs() >= tau[:, None], ec, 0.0)
        self.delta = ec - sp
        del ec
        mr = t < cfg.mean_removal_steps
        use_mr = float(mr)
        s_tilde = float((self.d_pad // c) * s)
        p_t = torch.full((), float(np.float32(cfg.p_avg)), device=self.device)
        ghat = torch.empty(self.d_pad, device=self.device)
        ys, sums, energies = [], [], []
        for j in range(cfg.shards):           # each slice's projection
            seed = shard_seed(cfg.ota_seed, j)
            xb = sp[:, j * L:(j + 1) * L].reshape(m, nb, c)
            y = torch.empty((m, nb, s), device=self.device)
            for g0 in range(0, nb, ota.BLOCK_GROUP):
                n = min(ota.BLOCK_GROUP, nb - g0)
                y[:, g0:g0 + n] = ota.product(
                    xb[:, g0:g0 + n].transpose(0, 1), self._a(seed, g0, n),
                    self.precision, transpose=True).transpose(0, 1)
            ys.append(y)
            flat = y.reshape(m, -1)
            sums.append([xla_sum(flat[i]) for i in range(m)])
            energies.append([xla_sum(flat[i] * flat[i]) for i in range(m)])
        del sp
        frames = []
        for i in range(m):                     # each device's frame power
            tot, en = sums[0][i], energies[0][i]
            for j in range(1, cfg.shards):
                tot, en = tot + sums[j][i], en + energies[j][i]
            mu = (use_mr * tot) * float(np.float32(1.0)
                                        / np.float32(s_tilde))
            e_az = rng.fma_f32(-(s_tilde - 1.0) * mu, mu, en) + 1.0
            ra = torch.sqrt(p_t / torch.clamp(e_az, min=1e-12))
            frames.append((ra, mu))
        for j in range(cfg.shards):           # the MAC and the PS
            body = slots = None
            for i in range(m):
                ra, mu = frames[i]
                b_i = ra * (ys[j][i] - mu)
                s_i = torch.stack([ra * mu, ra])
                body = b_i if body is None else body + b_i
                slots = s_i if slots is None else slots + s_i
            body = body + ota.noise(rng.fold_in(key, j)[None], nb * s,
                                    cfg.sigma2)[0].view(nb, s)
            slots = slots + ota.noise(rng.fold_in(key, cfg.shards + 7)[None],
                                      2, cfg.sigma2)[0]
            scale = torch.where(slots[1] > 1e-3, slots[1], 1.0)
            obs = (body + use_mr * slots[0]) / scale
            seed = shard_seed(cfg.ota_seed, j)
            out = ghat[j * L:(j + 1) * L].view(nb, c)
            for g0 in range(0, nb, ota.BLOCK_GROUP):
                n = min(ota.BLOCK_GROUP, nb - g0)
                out[g0:g0 + n] = ota.amp(obs[g0:g0 + n, None],
                                         self._a(seed, g0, n), cfg.amp_iters,
                                         self.precision)[:, 0]
        return ghat

    def step(self, t: int) -> float:
        """Step ``t``; returns ``global_loss``."""
        cfg = self.cfg
        key = ref.round_key(self.seed, t, cfg.key_rounds, self.device)
        gflat, loss = self.gradients(key)
        ghat = self.aggregate(gflat, t, key)
        del gflat
        tree = tfm.unflatten(ghat[: self.d], self.params)
        self.params, self.state = ref.adam(cfg, self.params, tree,
                                           self.state)
        return float(loss)


def run(cfg: Settings, seed: int, steps: int, device,
        precision: str = "float64", fault: Optional[str] = None) -> dict:
    """``steps`` steps from the seed: each step's ``global_loss``, the
    first step's ĝ per leaf and each leaf's change."""
    r = Step(cfg, seed, device, precision, fault)
    start = ref.host_copy(r.params)
    losses, grad = [], None
    for t in range(steps):
        losses.append(r.step(t))
        if t == 0:
            grad = ref.grad_norms(r.state["m"], cfg.b1)
    return {"losses": losses, "grad": grad,
            "change": ref.change_norms(r.params, start)}
