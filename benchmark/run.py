"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, where CUDA is missing or has fewer
devices than the cell asks for. See ``harness.py``.
"""

import time


def _process_age() -> float:
    """Seconds since this process started (Linux /proc), so that set-up
    counts the interpreter's start too; 0 where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os

        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

if __name__ == "__main__":
    import sys

    from benchmark.harness import main

    sys.exit(main(t_start=T_START))
