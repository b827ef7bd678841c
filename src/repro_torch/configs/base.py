"""Config dataclasses of the port: its own copy of the reference's.

The port imports nothing of the JAX package, so ``repro/configs/base.py``
is copied here field for field, defaults included: :class:`OTAConfig`,
:class:`ArchConfig` (with the block configs it refers to),
:class:`TrainConfig`, :class:`ShapeConfig`, ``INPUT_SHAPES``,
:func:`get_config`, :func:`ota_overrides`, :func:`approx_param_count` and
:func:`active_param_count`.  Every architecture of ``ARCH_IDS`` has its
config module in this package, copied as data, and the models of
:mod:`repro_torch.models` run all ten.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

# Block kinds understood by models/transformer.py
ATTN = "attn"            # full (GQA) self-attention + MLP
SWA = "swa"              # sliding-window self-attention + MLP
MAMBA2 = "mamba2"        # Mamba2 (SSD) mixer block
RWKV6 = "rwkv6"          # RWKV-6 (Finch) time-mix + channel-mix block
MOE = "moe"              # GQA self-attention + MoE MLP
MAMBA2_MLP = "mamba2_mlp"  # Mamba2 mixer + MLP in one block (granite-4.0-h)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int          # hidden dim of each expert's SwiGLU
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    expand: int = 2        # d_inner = expand * d_model
    head_dim: int = 64     # SSD head dim
    conv_width: int = 4
    chunk: int = 256       # SSD chunk length
    # the published Mamba2 mixer (opt-in; the port's own, beyond the
    # reference): one input projection, the causal conv over x, B and C
    # with bias, ``n_groups`` groups of B and C, a zero-padded last chunk
    # and the gated RMSNorm of ``y * silu(z)``
    published: bool = False
    n_groups: int = 1


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    chunk: int = 256       # chunked WKV recurrence length
    decay_lora: int = 64   # low-rank dim of the data-dependent decay
    ffn_mult: Optional[int] = None  # d_ff explicit on ArchConfig


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (conv frontend stubbed: inputs are frame embeds)."""
    n_layers: int = 6
    n_frames: int = 1500   # encoder sequence length after the (stubbed) conv
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None     # if set, SWA blocks
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # block pattern; if None, inferred from family
    block_pattern: Optional[Tuple[str, ...]] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None  # enc-dec (whisper)
    # hybrid (zamba2): one shared attention block applied every `shared_attn_every`
    # mamba layers, with shared (reused) weights.
    shared_attn_every: int = 0
    # vlm (qwen2-vl): M-RoPE section split of head_dim/2 into (t, h, w)
    mrope_sections: Optional[Tuple[int, int, int]] = None
    n_vision_tokens: int = 0         # stub patch-embedding prefix length
    citation: str = ""
    # Granite's multipliers and position embedding (the port's own, beyond
    # the reference); the defaults leave every other config's bits alone
    embedding_multiplier: float = 1.0    # scales the token embeddings
    attention_multiplier: Optional[float] = None  # score scale; None: 1/sqrt(hd)
    residual_multiplier: float = 1.0     # scales each block branch
    logits_scaling: float = 1.0          # divides the logits
    position_embedding: str = "rope"     # rope | nope

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def blocks(self) -> Tuple[str, ...]:
        """The per-layer block kinds (length n_layers)."""
        if self.block_pattern is not None:
            assert len(self.block_pattern) == self.n_layers
            return self.block_pattern
        if self.family == "moe":
            return (MOE,) * self.n_layers
        if self.family == "ssm":
            return (RWKV6,) * self.n_layers if self.rwkv else (MAMBA2,) * self.n_layers
        if self.family == "hybrid":
            return (MAMBA2,) * self.n_layers
        # dense / audio decoder / vlm
        return (ATTN,) * self.n_layers

    def reduced(self) -> "ArchConfig":
        """A tiny same-family variant for CPU smoke tests (2 layers, d<=512)."""
        d_model = min(self.d_model, 128)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        kw = dict(
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 256),
            vocab=min(self.vocab, 512),
            head_dim=32,
            block_pattern=None,
            n_vision_tokens=min(self.n_vision_tokens, 8),
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(num_experts=4, top_k=2, d_expert=64)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, expand=2, head_dim=32, chunk=32)
        if self.rwkv is not None:
            kw["rwkv"] = RWKVConfig(head_dim=32, chunk=32, decay_lora=16)
        if self.encoder is not None:
            kw["encoder"] = EncoderConfig(n_layers=2, n_frames=16, d_model=d_model,
                                          n_heads=n_heads, d_ff=128)
        if self.shared_attn_every:
            kw["shared_attn_every"] = 2
        if self.sliding_window:
            kw["sliding_window"] = 16
        if self.mrope_sections:
            kw["mrope_sections"] = (4, 6, 6)   # sums to head_dim/2 = 16
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# OTA aggregation config (the paper's technique)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OTAConfig:
    """Configuration of the gradient aggregation channel (paper §II-IV).

    A field-for-field copy of the reference's ``OTAConfig``, so a config
    means the same thing to both packages.  ``scheme`` names an entry of
    the port's registry (:mod:`repro_torch.core.schemes`); the axes the
    port does not run yet are rejected when a scheme is built.  The
    comments below name the reference modules that implement each axis.
    """
    scheme: str = "a_dsgd"     # any registered scheme name
    # channel
    s_frac: float = 0.5        # s = s_frac * d channel uses per iteration
    sigma2: float = 1.0        # AWGN variance (sigma^2)
    p_avg: float = 500.0       # average power budget P-bar
    power_schedule: str = "constant"   # constant | lh_stair | lh_steps | hl_steps
    total_steps: int = 300     # T, for the average-power constraint
    # A-DSGD
    k_frac: float = 0.5        # k = k_frac * s sparsity level
    amp_iters: int = 20
    mean_removal_steps: int = 20   # use the §IV-A variant for the first N steps
    # D-DSGD / digital baselines
    quant_bits: int = 2        # QSGD l_Q
    # projection realisation
    projection: str = "dense"  # dense (paper) | blocked (TPU framework path)
    block_size: int = 4096     # c — chunk of the flattened gradient (blocked path)
    rademacher: bool = False   # blocked path: ±1/sqrt(s_c) entries (kernel-friendly)
    use_kernel: bool = False   # route the blocked projection through Pallas
    # distribution
    num_groups: int = 0        # 0 => one OTA device per ('pod','data') coordinate
    state_dtype: str = "float32"   # error-accumulator dtype
    seed: int = 0
    # beyond-paper performance knobs (§Perf; defaults = paper-faithful)
    layout: str = "flat"       # flat | sliced (slice-local leafwise flatten)
    frame_dtype: str = "float32"   # bf16 halves the MAC psum payload
    shard_decode: bool = False     # split the redundant PS AMP across devices
    # beyond-paper channel model (follow-up [34]): block-flat Rayleigh fading
    # with truncated channel inversion.  ``fading="rayleigh"`` is the legacy
    # spelling — it promotes scheme "a_dsgd" to "a_dsgd_fading" in get_scheme.
    fading: str = "none"           # none | rayleigh
    fading_threshold: float = 0.3
    # channel-model axis (repro.core.fading): how gains evolve over rounds
    # and what the transmitters know about them.  fading_process selects the
    # traced program structure (static axis); rho / csi_err_var enter the
    # round as data, so they are vmappable sweep axes (docs/DESIGN.md §8).
    fading_process: str = "iid"    # static | iid | gauss_markov
    fading_rho: float = 0.9        # gauss_markov AR(1) correlation
    fading_window: int = 64        # gauss_markov moving-average window W
    csi_err_var: float = 0.0       # CSI estimate error variance (a_dsgd_csi_err)
    ps_antennas: int = 32          # K PS receive antennas (a_dsgd_blind)
    # robustness axis (repro.robust): fault injection + robust aggregation.
    # Defaults are bitwise-neutral: with ``robust=False`` and the zero rates
    # below, no new op enters the traced program (static gating), so every
    # pre-existing golden stays byte-identical.  ``robust=True`` (set
    # explicitly, or auto-promoted by the sweep engine when a robust axis is
    # swept) compiles the fault-injection path; the *rates* then enter the
    # round as traced scalars, so whole fault grids vmap on one program
    # (``ROBUST_VMAP_AXES`` in repro.experiments.sweep).
    robust: bool = False           # static master switch for fault injection
    byzantine_frac: float = 0.0    # persistent Byzantine fraction (traced)
    byz_attack: str = "sign_flip"  # static attack shape: sign_flip | scale
    byz_scale: float = 10.0        # attack magnitude (traced)
    fault_rate: float = 0.0        # per-round transient fault prob (traced)
    fault_kind: str = "nan"        # static: nan | inf | stale | dropout
    erasure_prob: float = 0.0      # digital packet-erasure prob (traced)
    # robust aggregation (independent of fault injection; static gates)
    aggregator: str = "mean"       # mean | trimmed_mean | median | norm_cap
    trim_frac: float = 0.1         # per-side trim fraction (traced)
    norm_cap: float = 1.0          # per-frame L2 cap, norm_cap agg (traced)
    clip_power: bool = False       # static: analog transmit-side power cap
    power_cap: float = 1.5         # cap as a multiple of P_t (traced)
    # geometry axis (repro.core.geometry): placement-derived large-scale
    # gains composed onto the small-scale fading draw.  ``geometry`` is the
    # static gate (``"none"`` keeps every pre-geometry golden byte-identical
    # — no geometry op enters the trace); cell_radius / path_loss_exp enter
    # the round as one traced scalar each (SCALAR_VMAP_AXES), the remaining
    # fields are structural GeometrySpec bits (docs/DESIGN.md §12).
    geometry: str = "none"         # none | disk (static placement model)
    cell_radius: float = 1000.0    # cell radius R in meters (traced)
    path_loss_exp: float = 3.0     # path-loss exponent gamma (traced)
    carrier_freq: float = 915e6    # f_c in Hz (static; link-budget diagnostics)
    bs_gain_db: float = 5.0        # BS antenna gain in dBi (static)
    user_gain_db: float = 0.0      # device antenna gain in dBi (static)
    bs_height: float = 10.0        # BS mast height in meters (static)
    geo_ref_dist: float = 100.0    # d0: gain = antenna gains alone (static)
    # subband scheduling axis (repro.core.scheduling): which devices
    # transmit each round.  ``scheduler`` selects the registered policy
    # (static program structure; "none" compiles no scheduling op);
    # ``n_subbands`` enters as a traced rank cutoff (SCALAR_VMAP_AXES);
    # ``pf_horizon`` shapes the prop_fair averaging and stays static.
    scheduler: str = "none"        # none | round_robin | gain_ranked | prop_fair
    n_subbands: int = 4            # S transmit slots per round (traced)
    pf_horizon: float = 10.0       # prop_fair average-rate horizon (static)
    # local-compute axis (repro.local): what devices do between uplinks.
    # ``local`` selects the registered algorithm (static program structure);
    # ``local_epochs`` / ``prox_mu`` / ``dyn_alpha`` enter the round as one
    # traced scalar each (LOCAL_VMAP_AXES in repro.experiments.sweep — the
    # epoch count rides a masked scan bounded by the static grid maximum).
    # Defaults are the paper's single-SGD-step device and keep every
    # committed golden byte-identical (docs/DESIGN.md §11).
    local: str = "sgd"             # sgd | fedavg | fedprox | feddyn
    local_epochs: int = 1          # E local passes per round (traced count)
    prox_mu: float = 0.0           # FedProx proximal strength mu (traced)
    dyn_alpha: float = 0.0         # FedDyn regulariser alpha (traced)

    def s_for(self, d: int) -> int:
        return max(2, int(self.s_frac * d))

    def k_for(self, d: int) -> int:
        return max(1, int(self.k_frac * self.s_for(d)))


# ---------------------------------------------------------------------------
# Architecture registry
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Train / shape configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adam"        # sgd | momentum | adam
    lr: float = 1e-3
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    seed: int = 0


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "zamba2_7b",
    "mistral_large_123b",
    "granite_moe_1b_a400m",
    "smollm_360m",
    "rwkv6_3b",
    "granite_moe_3b_a800m",
    "qwen3_8b",
    "yi_34b",
    "whisper_base",
    "qwen2_vl_7b",
)


#: configs of the port alone (``ARCH_IDS`` mirrors the reference's list)
PORT_ARCH_IDS = ("mnist_mlp", "granite_4_0_h_micro")


def get_config(arch: str) -> ArchConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS + PORT_ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS + PORT_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def ota_overrides(arch: str) -> OTAConfig:
    """Per-arch OTA defaults (framework path: blocked projection, modest rho)."""
    cfg = get_config(arch)
    n_params_b = approx_param_count(cfg) / 1e9
    state_dtype = "bfloat16" if n_params_b >= 30 else "float32"
    num_groups = 4 if n_params_b >= 30 else 0
    return OTAConfig(projection="blocked", s_frac=0.25, k_frac=0.5,
                     rademacher=True, state_dtype=state_dtype,
                     num_groups=num_groups, block_size=4096)


def approx_param_count(cfg: ArchConfig) -> int:
    """Closed-form parameter count used for rooflines (6ND model FLOPs)."""
    d, h = cfg.d_model, cfg.resolved_head_dim
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    total = cfg.vocab * d                       # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab * d                  # lm head
    attn = d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d
    swiglu = 3 * d * cfg.d_ff
    moe = 0
    if cfg.moe is not None:
        moe = cfg.moe.num_experts * 3 * d * cfg.moe.d_expert + d * cfg.moe.num_experts
    ssm = 0
    if cfg.ssm is not None:
        d_in = cfg.ssm.expand * d
        ssm = d * (2 * d_in + 2 * cfg.ssm.d_state) + d_in * d + 2 * d_in
    rwkv = 0
    if cfg.rwkv is not None:
        rwkv = 4 * d * d + d * d  # r,k,v,g,o projections approx
        rwkv += 2 * d * cfg.rwkv.decay_lora
        rwkv += 2 * d * cfg.d_ff // 1 if cfg.d_ff else 0
    for kind in cfg.blocks():
        if kind in (ATTN, SWA):
            total += attn + swiglu
        elif kind == MOE:
            total += attn + moe
        elif kind == MAMBA2:
            total += ssm
        elif kind == MAMBA2_MLP:
            total += _published_ssm_count(cfg) + swiglu
        elif kind == RWKV6:
            total += rwkv
    if cfg.shared_attn_every:
        total += attn + swiglu                   # one shared block
    if cfg.encoder is not None:
        e = cfg.encoder
        total += e.n_layers * (4 * e.d_model * e.d_model + 2 * e.d_model * e.d_ff)
        total += cfg.n_layers * (4 * cfg.d_model * cfg.d_model)  # cross-attn
    return int(total)


def _published_ssm_count(cfg: ArchConfig) -> int:
    """The published Mamba2 mixer's parameters, with its block's norms."""
    s, d = cfg.ssm, cfg.d_model
    d_in = s.expand * d
    heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return (d * (d_in + conv_dim + heads) + (s.conv_width + 1) * conv_dim
            + 3 * heads + d_in + d_in * d + 2 * d)


def active_param_count(cfg: ArchConfig) -> int:
    """Active (per-token) params — MoE counts only top_k experts."""
    if cfg.moe is None:
        return approx_param_count(cfg)
    full = approx_param_count(cfg)
    m = cfg.moe
    dead = (m.num_experts - m.top_k) * 3 * cfg.d_model * m.d_expert
    n_moe = sum(1 for k in cfg.blocks() if k == MOE)
    return int(full - n_moe * dead)
