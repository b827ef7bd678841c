"""Benchmark entry point: one harness per paper figure, the Theorem 1
bound, the dry run's roofline, and the kernel, sweep and streamed-LLM
benchmarks, on the port.

Prints a ``name,us_per_call,derived`` CSV summary at the end (derived =
final test accuracy for the figure benchmarks).  ``FULL=1`` in the
environment restores the paper-scale settings.

Run:  python -m repro_torch.benchmarks.run [fig2|...|fig13|thm1|roofline|kernels|sweeps|llm]
"""
from __future__ import annotations

import sys
import time


def main(device=None) -> None:
    from repro_torch.benchmarks import (
        bench_kernels, bench_llm, bench_sweeps, convergence_bound,
        fig2_schemes, fig3_power_alloc, fig4_power_sweep, fig5_bandwidth,
        fig6_devices,
        fig7_s_tradeoff, fig8_bias, fig9_fading, fig10_scaling, fig11_robust,
        fig12_local, fig13_geometry, roofline,
    )
    only = sys.argv[1] if len(sys.argv) > 1 else None
    benches = {
        "fig2": fig2_schemes.main,
        "fig3": fig3_power_alloc.main,
        "fig4": fig4_power_sweep.main,
        "fig5": fig5_bandwidth.main,
        "fig6": fig6_devices.main,
        "fig7": fig7_s_tradeoff.main,
        "fig8": fig8_bias.main,
        "fig9": fig9_fading.main,
        "fig10": fig10_scaling.main,
        "fig11": fig11_robust.main,
        "fig12": fig12_local.main,
        "fig13": fig13_geometry.main,
        "thm1": convergence_bound.main,
        "roofline": roofline.main,
        "kernels": bench_kernels.main,
        "sweeps": bench_sweeps.main,
        "llm": bench_llm.main,
    }
    if only is not None and only not in benches:
        raise SystemExit(f"unknown benchmark {only!r}; one of "
                         f"{', '.join(benches)}")
    summary = []
    for name, fn in benches.items():
        if only and name != only:
            continue
        print(f"\n===== {name} =====", flush=True)
        t0 = time.perf_counter()
        fn(collect=summary, device=device)
        print(f"[{name}] {time.perf_counter() - t0:.1f}s", flush=True)

    print("\nname,us_per_call,derived")
    for name, us, derived in summary:
        if isinstance(derived, float):
            print(f"{name},{us:.1f},{derived:.4f}")
        else:
            print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
