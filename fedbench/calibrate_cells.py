"""The readings the limits of a cell whose driver brings its own reference
are set from, many seeds in one process (``fedbench/calibrate.py`` reads
the cells of ``fedbench/reference/fedllm.py``'s round).

    python3 fedbench/calibrate_cells.py --workload <cell> --seeds 11 12 ... \\
        [--controls 2] [--out <file.jsonl>]

The cell's driver module has ``reference(config, workload, seed, rounds,
device, precision="float64", fault=None)``.  For each seed: the program's
set-up rounds through the driver, then the reference from the same seed,
and the gaps between them (the lower readings).  For the first
``--controls`` seeds, also the reference in TF32 (the control) and the
reference with each planted fault, each against the sound reference (the
upper readings).  One JSON line per run.  The benchmark's own runs never
run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from fedbench import bench  # noqa: E402
from fedbench.calibrate import CONTROLS  # noqa: E402
from fedbench.reference import fedllm as ref  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    spec = bench.cell_spec(args.workload)
    wl, config = spec["workload"], spec["config"]
    driver = bench.load_module("drivers", wl["driver"])
    rounds = wl["round"]["check_rounds"]
    out = open(args.out, "a") if args.out else None

    def write(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        cell = driver.Cell(config, wl, seed, "cuda")
        got = cell.setup()
        got["change"] = ref.change_norms(
            ref.tfm.tree_map(lambda t: t.to("cuda"), cell.end), cell.start)
        cell.release()
        del cell
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sound = driver.reference(config, wl, seed, rounds, "cuda")
        t2 = time.perf_counter()
        write({"seed": seed, "run": "program", "program_s": t1 - t0,
               "reference_s": t2 - t1, **ref.compare(got, sound),
               "losses": got["losses"], "ref_losses": sound["losses"]})
        torch.cuda.empty_cache()
        if i >= args.controls:
            continue
        for precision, fault in CONTROLS:
            t3 = time.perf_counter()
            other = driver.reference(config, wl, seed, rounds, "cuda",
                                     precision, fault)
            write({"seed": seed, "run": fault or precision,
                   "reference_s": time.perf_counter() - t3,
                   **ref.compare(other, sound)})
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
