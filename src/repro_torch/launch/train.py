"""End-to-end training driver, the port of the reference's
``repro/launch/train.py``.

Selects an architecture config (full or ``--reduced``), builds the mesh,
the OTA aggregator and the token pipeline, and runs the sharded train step
(:mod:`repro_torch.train.trainer`) for ``--steps`` steps with periodic
metrics and an optional checkpoint at the end.

The flags are the reference's, with one change: ``--device`` (the card
unless given, ``cpu`` for the CPU) takes the place of ``--devices``, the
reference's count of forced host devices.  Run alone, the mesh is one of
rank threads, which takes any shape on one device.  Under ``torchrun``
(``WORLD_SIZE`` in the environment) each process is one rank of a gloo
process-group mesh of ``WORLD_SIZE`` ranks on its own card
(``LOCAL_RANK``'s, :func:`repro_torch.sharding.process_device`), the
counterpart of ``jax.make_mesh`` over the devices jax sees; rank 0 prints
and writes ``--ckpt``.

  python -m repro_torch.launch.train --arch smollm_360m --reduced \\
      --mesh 4x2 --steps 200 --aggregator a_dsgd --device cpu
  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --mesh 2x2 --steps 5
"""
from __future__ import annotations

import argparse
import os
import time

from repro_torch import rng
from repro_torch import sharding
from repro_torch.configs import get_config
from repro_torch.configs.base import OTAConfig, TrainConfig
from repro_torch.data.synthetic import TokenStream
from repro_torch.sharding import Mesh
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.trainer import make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--mesh", default="4x2", help="DxM or PxDxM")
    ap.add_argument("--aggregator", default="a_dsgd",
                    choices=["ideal", "a_dsgd"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--p-avg", type=float, default=500.0)
    ap.add_argument("--s-frac", type=float, default=0.25)
    ap.add_argument("--block-size", type=int, default=512)
    ap.add_argument("--site-ota", action="store_true",
                    help="ota_axes=('pod',): edge sites = pods")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dims = [int(x) for x in args.mesh.split("x")]
    names = ("pod", "data", "model")[-len(dims):]
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return _train(args, Mesh(tuple(dims), names), names, dims, True)
    # one rank of a process group: its card first (no card and no
    # --device cpu raises before the group is joined)
    sharding.process_device(args.device)
    rank = int(os.environ["RANK"])
    mesh = sharding.init_process_mesh(dims, names, rank=rank,
                                      world_size=world, init_method="env://")
    try:
        return _train(args, mesh, names, dims, rank == 0)
    finally:
        sharding.close_process_mesh()


def _train(args, mesh, names, dims, lead: bool) -> int:
    """The run on ``mesh``; ``lead``: this process prints and writes the
    checkpoint."""
    def say(text):
        if lead:
            print(text, flush=True)

    arch = get_config(args.arch)
    if args.reduced:
        arch = arch.reduced()
    train_cfg = TrainConfig(optimizer="adam", lr=args.lr, warmup_steps=10,
                            total_steps=args.steps,
                            compute_dtype="float32" if args.reduced
                            else "bfloat16", remat=True)
    ota = OTAConfig(scheme=args.aggregator, projection="blocked",
                    block_size=args.block_size, s_frac=args.s_frac,
                    k_frac=0.5, rademacher=True, p_avg=args.p_avg,
                    total_steps=args.steps, amp_iters=10,
                    mean_removal_steps=10)
    ota_axes = (("pod",) if args.site_ota and "pod" in names
                else tuple(a for a in names if a in ("pod", "data")))
    ts = make_train_step(arch, train_cfg, ota, mesh, ota_axes=ota_axes,
                         device=args.device)
    say(f"[train] arch={arch.name} d={ts.d:,} M={ts.m_devices} "
        f"mesh={dict(zip(names, dims))} ota_axes={ota_axes} "
        f"device={ts.device}")

    params, opt_state, delta = ts.init_state(rng.PRNGKey(0))
    stream = TokenStream(vocab=arch.vocab, seq_len=args.seq,
                         batch=args.batch, seed=0)
    step_fn = ts.jitted({"tokens": None})
    t0 = time.time()
    for step in range(args.steps):
        batch = stream.batch_at(step)
        params, opt_state, delta, met = step_fn(
            params, opt_state, delta, batch, step,
            rng.PRNGKey(step, device=ts.device))
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d}  loss {float(met['global_loss']):.4f}  "
                f"ppl {float(met['ppl']):.1f}  "
                f"{(time.time() - t0) / (step + 1):.2f}s/step")
    if args.ckpt and lead:
        save_checkpoint(args.ckpt, {"params": params, "opt": opt_state},
                        step=args.steps)
        say(f"[train] checkpoint -> {args.ckpt}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
