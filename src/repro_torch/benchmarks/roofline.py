"""Roofline analysis: the three terms per (arch x shape x mesh) from the dry
run's records in ``results/dryrun_torch/``, on an H100's peaks.

The port of the reference's ``benchmarks/roofline.py`` (deliverable g):

  compute    = FLOPs / (chips x PEAK_FLOPS_BF16)
  memory     = bytes accessed per device / HBM_BW
  collective = collective bytes per device / LINK_BW

The memory and collective terms read the busiest device's counts in the
record (:mod:`repro_torch.launch.dryrun`; ``bytes_accessed`` there is an
unfused upper bound).  FLOPs use the reference's analytic workload model
(6 N_active D + the attention quadratic + the OTA encode/decode pipeline),
copied so that it gives the reference's numbers bit for bit, as the
reference's roofline reads its own records with it.  That copy keeps a
defect of the reference: a row counts the OTA encode of ``m_devices=16``
devices whatever its mesh, where ``ota_axes=("pod", "data")`` on 2 x 16 x
16 gives 32.  The constants are parameters of :func:`load_rows`, so the
reference's TPU v5e constants give the reference's rows.

Run:  python -m repro_torch.benchmarks.run roofline
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs import (
    INPUT_SHAPES, active_param_count, approx_param_count, get_config,
    ota_overrides,
)
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch")


def analytic_flops(arch_id: str, shape_id: str, kind: str,
                   aggregator: Optional[str], m_devices: int = 16,
                   n_shards: int = 16, n_chips: int = 256) -> Dict[str, float]:
    """Global FLOPs model. Returns dict with model/train/ota components."""
    cfg = get_config(arch_id)
    shape = INPUT_SHAPES[shape_id]
    n_active = active_param_count(cfg)
    B, L = shape.global_batch, shape.seq_len
    d_attn = cfg.n_heads * cfg.resolved_head_dim
    n_attn = sum(1 for k in cfg.blocks() if k in ("attn", "swa", "moe"))
    if cfg.shared_attn_every:
        n_attn += cfg.n_layers // cfg.shared_attn_every
    if kind == "train":
        tokens = B * L
        fwd = 2.0 * n_active * tokens + 2.0 * B * L * L * d_attn * n_attn
        model = 3.0 * fwd                 # fwd + 2x bwd
        total = model * (4.0 / 3.0)       # block remat ~ one extra fwd
        ota = 0.0
        if aggregator == "a_dsgd":
            oc = ota_overrides(arch_id)
            d = _param_total(cfg)
            s_block = oc.s_frac * oc.block_size
            encode = 12.0 * d * s_block * m_devices          # gen + matmul
            decode = (10.0 + 4.0 * oc.amp_iters) * d * s_block \
                * (n_chips / n_shards)   # replicated across data rows
            ota = encode + decode
        return {"model_flops": 6.0 * n_active * tokens, "total": total + ota,
                "ota": ota}
    if kind == "prefill":
        tokens = B * L
        fwd = 2.0 * n_active * tokens + 2.0 * B * L * L * d_attn * n_attn
        return {"model_flops": 2.0 * n_active * tokens, "total": fwd,
                "ota": 0.0}
    # decode: one token, KV-cache attention reads
    fwd = 2.0 * n_active * B + 4.0 * B * L * d_attn * n_attn
    return {"model_flops": 2.0 * n_active * B, "total": fwd, "ota": 0.0}


def _param_total(cfg) -> float:
    return float(approx_param_count(cfg))


def _amp_share(info: Dict) -> Optional[float]:
    """``amp_fused``'s share of the thread mesh's counted operations."""
    amp = (info.get("kernels") or {}).get("amp_fused")
    total = (info.get("thread_mesh") or {}).get("flops")
    if not amp or not total:
        return None
    return amp["ops"] / total


def dominant_advice(dom: str, info: Dict) -> str:
    if dom == "collective":
        return ("shrink the MAC psum's payload (lower s_frac, fewer OTA "
                "rows) or overlap it with the backward pass; on the thread "
                "mesh each collective is a barrier of every rank")
    if dom == "memory":
        return ("cut HBM traffic: the unfused elementwise passes around "
                "ef_sparsify and the frame's sums, the flatten into the "
                "gradient stack, a bfloat16 Delta")
    share = _amp_share(info)
    amp = (f"amp_fused is {share:.0%} of the counted operations: "
           if share is not None else "")
    return (amp + "decode each device row's share of the blocks "
            "(shard_decode) or fewer AMP iterations; the thread mesh runs "
            "its ranks one after another on one card")


def load_rows(mesh_filter: Optional[str] = None,
              results: Optional[str] = None,
              peak_flops: float = PEAK_FLOPS_BF16, hbm_bw: float = HBM_BW,
              link_bw: float = LINK_BW) -> List[Dict]:
    """The roofline rows of the records in ``results`` (default
    :data:`RESULTS`) on the given peaks (default the H100's)."""
    results = results or RESULTS
    rows = []
    for path in sorted(glob.glob(os.path.join(results, "*.json"))):
        with open(path) as f:
            info = json.load(f)
        if "skipped" in info:
            info["tag"] = os.path.basename(path)[:-5]
            rows.append(info)
            continue
        if mesh_filter and info["mesh"] != mesh_filter:
            continue
        n = info["n_chips"]
        af = analytic_flops(info["arch"], info["shape"], info["kind"],
                            info.get("aggregator"), n_chips=n)
        t_comp = af["total"] / (n * peak_flops)
        t_mem = info["bytes_accessed"] / hbm_bw          # per-device already
        t_coll = info["collective_bytes"]["total"] / link_bw
        terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
        dom = max(terms, key=terms.get)
        rows.append({
            **info,
            "tag": os.path.basename(path)[:-5],
            "flops_analytic": af["total"],
            "model_flops": af["model_flops"],
            "ota_flops": af["ota"],
            "t_compute": t_comp, "t_memory": t_mem, "t_collective": t_coll,
            "dominant": dom,
            "useful_ratio": af["model_flops"] / max(af["total"], 1.0),
            "advice": dominant_advice(dom, info),
        })
    return rows


def main(collect=None, device=None):
    """Print the CSV of :func:`load_rows` and write
    ``results/roofline_table_torch.json``.  ``device`` is the registry's
    argument and goes unused: the roofline reads records on the host."""
    rows = load_rows()
    hdr = ("arch,shape,mesh,variant,aggregator,t_compute_s,t_memory_s,"
           "t_collective_s,dominant,model/total_flops,temp_GiB_per_dev")
    print(hdr)
    for r in rows:
        if "skipped" in r:
            print(f"{r['tag']},SKIPPED({r['skipped'][:40]})")
            continue
        tmp = (r["mem_per_device"]["temp_bytes"] or 0) / 2**30
        print(f"{r['arch']},{r['shape']},{r['mesh']},{r['variant']},"
              f"{r.get('aggregator')},{r['t_compute']:.4f},"
              f"{r['t_memory']:.4f},{r['t_collective']:.4f},{r['dominant']},"
              f"{r['useful_ratio']:.3f},{tmp:.2f}")
        if collect is not None:
            collect.append((f"roofline_{r['tag']}", 0.0, r["dominant"]))
    os.makedirs(RESULTS, exist_ok=True)
    out = os.path.join(RESULTS, "..", "roofline_table_torch.json")
    with open(out, "w") as f:
        json.dump([{k: v for k, v in r.items() if k != "advice"}
                   for r in rows], f, indent=1, default=str)
    return rows


if __name__ == "__main__":
    main()
