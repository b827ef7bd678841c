"""Serving demo: batched greedy decoding with per-family caches.

Runs a reduced dense model (smollm_360m: KV caches) and a reduced RWKV6
(rwkv6_3b: recurrent state) through a teacher-forced prompt and greedy
decoding, one ``decode_step`` per position, in float32 on one device.

Run:  python -m repro_torch.examples.serve_demo
"""
import torch

from repro_torch import rng
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import (
    decode_step, init_decode_cache, init_params,
)


def main(device=None):
    dev = resolve_device(device)
    out = {}
    for arch_id in ("smollm_360m", "rwkv6_3b"):
        cfg = get_config(arch_id).reduced()
        params = init_params(cfg, rng.PRNGKey(0, device=dev))
        B, prompt_len, gen_len = 4, 8, 24
        prompt = rng.randint(rng.PRNGKey(1, device=dev), (B, prompt_len), 0,
                             cfg.vocab)
        cache = init_decode_cache(cfg, B, prompt_len + gen_len,
                                  torch.float32, device=dev)
        tok = prompt[:, :1]
        seq = [tok]
        for pos in range(prompt_len + gen_len - 1):
            logits, cache = decode_step(params, cfg, tok, cache, pos,
                                        compute_dtype=torch.float32)
            tok = (prompt[:, pos + 1:pos + 2] if pos + 1 < prompt_len
                   else torch.argmax(logits[:, -1:], -1).to(torch.int32))
            seq.append(tok)
        seq = torch.cat(seq, 1)
        out[arch_id] = seq
        print(f"{arch_id:14s} generated {tuple(seq.shape)} tokens; "
              f"sample row: {seq[0, :16].tolist()}")
    return out


if __name__ == "__main__":
    main()
