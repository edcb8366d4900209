"""What every part of the harness shares: finding a cell's files by name,
the H100's published peaks, a kernel's least time, and the statistics.

A configuration, traffic mix, metric or kernel count is a file of its own,
found by the name `BENCHMARK.json` gives it:

    configs/<config>.json     the frozen config, its source and cuts
    traffic/<traffic>.json    the stream's parameters
    metrics/<metric>.py       read(run) -> float or None
    kernels/<kernel>.py       TRACE and launches(shp, iters)
    limits/<workload>.json    the limits of the output check
"""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """slambench/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"slambench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def least_s(n_bytes: float, n_flops: float) -> float:
    """The least time the card could take: bytes at the memory rate or
    operations at the f32 rate, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS)


def kernel_work(kernel: str, shp: dict, iters: dict) -> tuple:
    """(least seconds, bytes, flops, launches) of one kernel over the
    iterations `iters` ({"track", "map", "probe"} counts)."""
    rows = load_module("kernels", kernel).launches(shp, iters)
    return (sum(n * least_s(b, f) for n, b, f in rows),
            sum(n * b for n, b, f in rows), sum(n * f for n, b, f in rows),
            sum(n for n, _, _ in rows))


def device_s(trace: dict, names) -> float:
    """Device seconds of the trace's kernels whose name holds any of
    `names`."""
    return sum(us for k, (us, _) in trace["kernels"].items()
               if any(n in k for n in names)) / 1e6


def roofline(run: dict, kernel: str):
    """A kernel's share (%) of its roofline over the profiled stretch: its
    least time at these shapes over its device time; None where it did not
    run."""
    tr = run.get("trace")
    if not tr:
        return None
    least, _, _, launches = kernel_work(kernel, run["shapes"], tr["iters"])
    dev = device_s(tr, load_module("kernels", kernel).TRACE)
    if launches == 0 or dev <= 0:
        return None
    return 100.0 * least / dev


def quantile(values, q: float) -> float:
    """The q-quantile by linear interpolation between order statistics
    (numpy's default), over every value."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
