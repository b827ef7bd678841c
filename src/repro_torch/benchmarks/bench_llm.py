"""Streamed fedllm benchmark: rounds/sec and tokens/sec-while-training.

The port of the reference's ``benchmarks/bench_llm.py``.  Runs the
serve-while-train loop (:func:`repro_torch.train.fedllm.serve_while_train`)
at smollm_360m scale and writes ``BENCH_torch_llm.json`` at the
repository's root in the schema of ``BENCH_llm.json`` (flat
``*_us_per_round`` keys, which ``benchmarks/check_regression.py`` gates),
with the device's name and power limit:

* ``train_us_per_round``        -- one streamed OTA round (grads ->
                                   chunked encode/MAC/decode -> optimizer),
                                   steady state (after the first round).
* ``serve_train_us_per_round``  -- the same round plus the between-rounds
                                   serve traffic (publish + prefill +
                                   greedy decode batch).
* ``compiled_cold_us_per_round``-- the first round (reported, never gated).
* ``rounds_per_sec`` / ``tokens_per_sec_while_training`` -- the derived
                                   rates (reported, not gated).

On the card the chunks run the kernels (``use_kernel=True``; the blocked
sizes below are shapes they take) and every clock read follows a
synchronise.  ``SMOKE=1`` runs the ``.reduced()`` smollm_360m (2 layers,
d_model 128); the default and ``FULL=1`` raise rounds and chunk budget,
and ``FULL=1`` runs the published widths in bfloat16.  The loop's own
checks run either way: >= 2 OTA rounds, a decode batch between rounds,
published params bitwise the decoded globals.

Run:  python -m repro_torch.benchmarks.run llm
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

from repro_torch.benchmarks.common import REPO_ROOT

OUT_PATH = os.path.join(REPO_ROOT, "BENCH_torch_llm.json")

SMOKE = bool(int(os.environ.get("SMOKE", "0")))
FULL = bool(int(os.environ.get("FULL", "0")))


def bench_spec():
    """(reduced, rounds, m, chunk_size, decode_steps)."""
    if SMOKE:
        return True, 2, 3, 1 << 14, 2
    if FULL:
        return False, 3, 4, 1 << 18, 8
    return True, 3, 4, 1 << 15, 4


def main(collect: Optional[list] = None, out_path: str = OUT_PATH,
         device=None) -> Dict:
    import math

    import numpy as np

    from repro_torch.benchmarks.common import clock, device_info
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OTAConfig, TrainConfig, ota_overrides
    from repro_torch.device import resolve_device
    from repro_torch.experiments.engine import round_keys
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.fedllm import CompiledFedLLM, serve_while_train

    dev = resolve_device(device)
    reduced, rounds, m, chunk_size, decode_steps = bench_spec()
    arch = get_config("smollm_360m")
    if reduced:
        arch = arch.reduced()
    base = ota_overrides("smollm_360m")
    block = min(base.block_size, max(chunk_size // 4, 256))
    ota = OTAConfig(projection="blocked", s_frac=base.s_frac,
                    k_frac=base.k_frac, rademacher=base.rademacher,
                    block_size=block, use_kernel=dev.type == "cuda")
    tc = TrainConfig(compute_dtype="float32" if reduced else "bfloat16")
    batch, seq_len, serve_batch, prompt_len = 2, 16, 2, 4

    # -- train-only: the first round, then the steady rounds --------------
    fed = CompiledFedLLM(arch, tc, ota, m=m, batch=batch, seq_len=seq_len,
                         chunk_size=chunk_size, seed=0, device=dev)
    keys = round_keys(rounds + 1, 0, device=dev)
    carry = fed.carry0()
    t0 = clock(dev)
    carry, _ = fed.run_segment({}, keys[:1], None, carry, 0)
    cold_s = clock(dev) - t0
    t0 = clock(dev)
    carry, _ = fed.run_segment({}, keys[1:rounds + 1], None, carry, 1)
    train_s = (clock(dev) - t0) / rounds
    del carry

    # -- serve-while-train: the whole loop ---------------------------------
    t0 = clock(dev)
    out = serve_while_train(arch, rounds=rounds, ota=ota, train_cfg=tc,
                            m=m, batch=batch, seq_len=seq_len,
                            chunk_size=chunk_size, serve_batch=serve_batch,
                            prompt_len=prompt_len,
                            decode_steps=decode_steps, seed=0,
                            mesh=make_local_mesh(), device=dev)
    swt_s = clock(dev) - t0
    if not (len(out["served_tokens"]) == rounds >= 2):
        raise RuntimeError("bench_llm: the loop did not serve every round")
    if not all(map(math.isfinite, out["losses"])):
        raise RuntimeError(f"bench_llm: training losses {out['losses']}")
    if not out["publish_bitwise"]:
        raise RuntimeError("bench_llm: served params != decoded globals")
    served_tokens = rounds * serve_batch * (prompt_len + decode_steps)
    serve_round_s = swt_s / rounds
    secs = out["seconds"]

    doc = {
        **device_info(dev),
        "smoke": SMOKE,
        "arch": "smollm_360m" + (".reduced" if reduced else ""),
        "d": fed.d,
        "n_chunks": fed.n_chunks,
        "chunk_len": fed.chunk_len,
        "m_devices": m,
        "rounds": rounds,
        "use_kernel": ota.use_kernel,
        "train_us_per_round": round(train_s * 1e6, 1),
        "serve_train_us_per_round": round(serve_round_s * 1e6, 1),
        "compiled_cold_us_per_round": round(cold_s * 1e6, 1),
        "rounds_per_sec": round(1.0 / train_s, 4),
        "tokens_per_sec_while_training": round(served_tokens / swt_s, 2),
        "serve_ms_per_round": {
            k: float(np.median([s[k] for s in secs]) * 1e3)
            for k in ("publish", "prefill", "decode")},
    }
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(json.dumps(doc, indent=1))
    if collect is not None:
        collect.append(("llm", doc["train_us_per_round"],
                        doc["tokens_per_sec_while_training"]))
    return doc


if __name__ == "__main__":
    main()
