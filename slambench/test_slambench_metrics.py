"""Each metric file's arithmetic on hand-made run records."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from slambench import lib  # noqa: E402


def read(name, run):
    return lib.load_module("metrics", name).read(run)


def test_every_benchmark_metric_has_a_reader():
    b = lib.benchmark()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(lib.load_module("metrics", m["name"]).read)


def test_rate_is_all_frames_over_the_whole_window():
    run = {"window": {"n": 30, "wall_s": 12.5, "frame_ms": [1.0] * 30}}
    assert read("frames_per_s", run) == pytest.approx(2.4)


def test_p95_is_over_every_frame():
    ms = [100.0] * 19 + [300.0]
    run = {"window": {"n": 20, "wall_s": 2.2, "frame_ms": ms}}
    # 0.95 * 19 = 18.05: 5% of the way from the 19th value to the 20th
    assert read("frame_ms_p95.host", run) == pytest.approx(110.0)
    ms = [float(i) for i in range(1, 101)]
    assert read("frame_ms_p95.host", {"window": {"frame_ms": ms[::-1]}}) == \
        pytest.approx(95.05)


def test_memory_and_setup():
    assert read("peak_mem_gib", {"peak_bytes": 3 * 2 ** 29}) == 1.5
    assert read("peak_mem_gib", {}) is None
    assert read("setup_s", {"setup_s": 21.5}) == 21.5


def test_phase_metrics():
    run = {"stats": {"frames": 10, "iters": {"track": 96, "map": 45,
                                             "probe": 45},
                     "phase_s": {"tracking": 0.96, "mapping": 0.9}}}
    assert read("track_ms_per_iter", run) == pytest.approx(10.0)
    assert read("map_ms_per_iter", run) == pytest.approx(20.0)
    assert read("track_iters_per_frame", run) == pytest.approx(9.6)
    assert read("map_iters_per_frame", run) == pytest.approx(4.5)
    assert read("track_ms_per_iter", {}) is None


def test_trace_metrics():
    from slambench import shapes

    shp = shapes.of(lib.load_json("configs", "replica_room0_hash")["slam"])
    it = {"track": 64, "map": 30, "probe": 0}
    run = {"shapes": shp, "trace": {"wall_s": 2.0, "busy_s": 0.3,
                                    "frames": 8, "launches": 40000,
                                    "iters": it, "kernels": {}}}
    assert read("launches_per_frame", run) == 5000.0
    assert read("device_idle_share", run) == pytest.approx(85.0)
    flops = sum(lib.kernel_work(k, shp, it)[2] for k in (
        "hash_encode_fwd", "hash_encode_bwd", "scatter_accum", "composite",
        "decoders", "adam"))
    assert read("mfu", run) == pytest.approx(100 * flops / (2.0 * 67e12))
    # no device time for a kernel: its share is left out, never 0
    assert read("hash_encode_fwd_roofline", run) is None
    for name in ("launches_per_frame", "device_idle_share", "mfu"):
        assert read(name, {"shapes": shp}) is None
