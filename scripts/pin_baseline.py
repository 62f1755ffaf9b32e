"""Measure and print the PINNED host-numpy baseline constant for bench.py.

Re-measuring the reference numpy baseline on every run made
`vs_baseline` swing 90.7x -> 245x -> 1242x with a near-constant device
numerator — the ratio measured the host's load, not the work. The fix is a stored median-of-N measurement taken on a
quiet host, re-measured only on demand (this script), with the live
ratio still reported alongside for drift detection.

Run on an otherwise-idle host:
    python scripts/pin_baseline.py
then paste the printed PINNED_BASELINE dict into bench.py.
"""

import json
import os
import platform
import time

import numpy as np


def host_fingerprint():
    cpu = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    cpu = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{cpu} x{os.cpu_count()}"


def main():
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from bench import reference_numpy_ts

    nb = 10_000_000
    rng = np.random.RandomState(0)
    t = (14.0 + 8.0 * rng.randn(nb)).astype(np.float32)
    s = (35.0 + 1.5 * rng.randn(nb)).astype(np.float32)
    t_edges = np.linspace(-2.0, 30.0, 281).astype(np.float32)
    s_edges = np.linspace(30.0, 40.0, 341).astype(np.float32)

    reference_numpy_ts(t, s, t_edges, s_edges)  # warm (allocator, caches)
    times = []
    for _ in range(9):
        t0 = time.perf_counter()
        reference_numpy_ts(t, s, t_edges, s_edges)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    gbps = nb * 8 / med / 1e9
    pinned = {
        "gbps": round(gbps, 4),
        "median_ms": round(med * 1e3, 1),
        "reps": 9,
        "elems": nb,
        "date": time.strftime("%Y-%m-%d"),
        "host": host_fingerprint(),
    }
    print(f"# per-rep ms: {[round(x * 1e3, 1) for x in times]}")
    print("PINNED_BASELINE = " + json.dumps(pinned, indent=4))


if __name__ == "__main__":
    main()
