"""Distributed OTA training on a mesh of 8 rank threads.

Demonstrates the framework path on the port: a real transformer (reduced
SmolLM family), data-parallel edge devices on the mesh's 'data' axis, the
'model' axis sharding the gradient's slices, and the A-DSGD aggregation
(blocked projection + AMP) replacing the gradient all-reduce
(:mod:`repro_torch.train.trainer`).

Run:  python -m repro_torch.examples.distributed_ota   (on the card)
"""
from repro_torch import rng
from repro_torch.configs import get_config
from repro_torch.configs.base import OTAConfig, TrainConfig
from repro_torch.data.synthetic import TokenStream
from repro_torch.sharding import Mesh
from repro_torch.train.trainer import make_train_step


def main(steps: int = 30, device=None):
    mesh = Mesh((4, 2), ("data", "model"))
    arch = get_config("smollm_360m").reduced()
    train_cfg = TrainConfig(optimizer="adam", lr=5e-3, warmup_steps=5,
                            total_steps=60, compute_dtype="float32",
                            remat=True)
    ota = OTAConfig(scheme="a_dsgd", projection="blocked", block_size=512,
                    s_frac=0.25, k_frac=0.5, rademacher=True, p_avg=500.0,
                    total_steps=60, amp_iters=10, mean_removal_steps=5)

    ts = make_train_step(arch, train_cfg, ota, mesh, ota_axes=("data",),
                         device=device)
    print(f"model d={ts.d:,} padded={ts.d_pad:,}  OTA devices "
          f"M={ts.m_devices}  error-feedback state {ts.delta_shape}")

    params, opt_state, delta = ts.init_state(rng.PRNGKey(0))
    stream = TokenStream(vocab=arch.vocab, seq_len=64, batch=16, seed=0)
    step_fn = ts.jitted({"tokens": None})

    for step in range(steps):
        # cycle a small batch set so learning is visible within a short demo
        batch = stream.batch_at(step % 4)
        params, opt_state, delta, metrics = step_fn(
            params, opt_state, delta, batch, step,
            rng.PRNGKey(step, device=ts.device))
        if step % 5 == 0:
            print(f"step {step:3d}  loss {float(metrics['global_loss']):.4f}"
                  f"  frame power {float(metrics['frame_power']):.1f}")
    print("done — loss should be decreasing while every gradient exchange "
          "went through the simulated wireless MAC.")


if __name__ == "__main__":
    main()
