"""python -m benchmark --workload NAME --seed N --seconds S --trace 0|1:
one run of one cell of ``BENCHMARK.json`` (``run.py``)."""

import os
import sys
import time


def process_start() -> float:
    """This process's start on ``time.monotonic``'s clock, read from
    /proc (to 10 ms), or now where /proc cannot tell."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        since_boot = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - since_boot
    except (OSError, IndexError, ValueError, AttributeError):
        return now
    return now - max(0.0, age)


if __name__ == "__main__":
    STARTED = process_start()
    from benchmark.run import main

    sys.exit(main(started=STARTED))
