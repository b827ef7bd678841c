"""Paper §VI reproduction entry point on the port: pick a figure and
render its data as CSV.

Run:  python -m repro_torch.examples.paper_repro [fig2|fig3|...|fig13|thm1]
      FULL=1 ... for the paper-scale settings (M=25, B=1000, T=300).
"""
import sys


def main(device=None):
    from repro_torch.benchmarks import run as bench_run

    sys.argv = ["paper_repro"] + (sys.argv[1:] or ["fig2"])
    bench_run.main(device=device)


if __name__ == "__main__":
    main()
