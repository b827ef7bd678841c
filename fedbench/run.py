"""The benchmark's command: one run of one cell.

    python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``fedbench/README.md``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402


def _process_age() -> float:
    """Seconds since this process started, from ``/proc`` (0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == "__main__":
    T_START -= _process_age()
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from fedbench import bench

    sys.exit(bench.main(sys.argv[1:], T_START))
