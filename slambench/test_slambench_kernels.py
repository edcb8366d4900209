"""The benchmark's kernel counts against the smoke's (`chip_smoke.py`):
launches per iteration, and each launch's bytes and operations at the
timed shapes; and its sizes against the port's own spec."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from slambench import lib, shapes  # noqa: E402

CONFIGS = ("replica_room0_hash",)
ITERS = {"track": 37, "map": 23, "probe": 11}


def _shp(name):
    return shapes.of(lib.load_json("configs", name)["slam"])


@pytest.mark.parametrize("name", CONFIGS)
def test_sizes_are_the_ports(name):
    from unislam_tpu_torch.engine.slam import intrinsics_from_cfg
    from unislam_tpu_torch.models.scene import make_scene_config

    cfg = lib.load_json("configs", name)["slam"]
    shp, sc = shapes.of(cfg), make_scene_config(cfg)
    assert shp["intr"] == intrinsics_from_cfg(cfg)._asdict()
    assert np.array_equal(shp["bound"], sc.bound)
    for g, spec in (("sdf", sc.sdf_spec), ("color", sc.color_spec)):
        G = shp["grids"][g]
        assert np.array_equal(G["scales"], spec.scales)
        assert np.array_equal(G["res"], spec.resolutions)
        assert np.array_equal(G["offsets"], spec.offsets[:-1])
        assert np.array_equal(G["hashed"], spec.hashed)
        assert G["T"] == spec.total_entries and G["L"] == spec.n_levels


@pytest.mark.parametrize("kernel,smoke", [
    ("hash_encode_fwd", "hash_encode_fwd"), ("hash_encode_bwd",
                                             "hash_encode_bwd"),
    ("scatter_accum", "scatter_accumulate")])
def test_launch_counts_are_the_smokes(kernel, smoke):
    import chip_smoke

    want = chip_smoke.expected_launches("hash", "vanilla", "float32", 0,
                                        ITERS)[smoke]
    rows = lib.load_module("kernels", kernel).launches(_shp(CONFIGS[0]),
                                                       ITERS)
    assert sum(n for n, _, _ in rows) == want


def test_composite_launches_are_the_smokes():
    import chip_smoke

    want = chip_smoke.expected_launches("hash", "vanilla", "float32", 0,
                                        ITERS)
    rows = lib.load_module("kernels", "composite").launches(
        _shp(CONFIGS[0]), ITERS)
    assert sum(n for n, _, _ in rows) == want["composite_fwd"] \
        + want["composite_bwd"]


# the smoke's expressions (chip_smoke.check_kernels, check_scatter,
# check_k3), at its timed shapes: the room0 config, mapping 4,200 rays and
# tracking 2,000 of 40 samples, the probe's 4,200 x 32
def _smoke_rows(shp):
    S, P = shp["samples"], shp["probe_samples"]
    out = {"hash_encode_fwd": [], "hash_encode_bwd": [],
           "scatter_accum": [], "composite": []}
    for R, rows_wanted in ((shp["track_rays"], False),
                           (shp["map_rays"], True)):
        N = R * S
        for g in ("sdf", "color"):
            T, L = shp["grids"][g]["T"], shp["grids"][g]["L"]
            out["hash_encode_fwd"].append((N * 12 + T * 8 + N * L * 8,
                                           N * L * 8 * 4))
            out["hash_encode_bwd"].append(
                (N * 12 + N * L * 8 + T * 8 + N * 12
                 + rows_wanted * N * L * 8 * (4 + 8), N * L * 8 * 12))
            if rows_wanted:
                M, D = L * N * 8, 2
                out["scatter_accum"].append((M * 4 + M * D * 4 + T * D * 4,
                                             M * D))
        out["composite"] += [(R * S * 20 + R * 28 + 4, R * S * 40),
                             (R * S * 36 + R * 20 + 8, R * S * 60)]
    R = shp["map_rays"]
    T, L = shp["grids"]["sdf"]["T"], shp["grids"]["sdf"]["L"]
    out["hash_encode_fwd"].append((R * P * 12 + T * 8 + R * P * L * 8,
                                   R * P * L * 8 * 4))
    out["composite"].append((R * P * 12 + R * 4 + 4, R * P * 12))
    return out


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("kernel", ["hash_encode_fwd", "hash_encode_bwd",
                                    "scatter_accum", "composite"])
def test_bytes_and_operations_are_the_smokes(name, kernel):
    shp = _shp(name)
    ours = sorted((b, f) for _, b, f in lib.load_module(
        "kernels", kernel).launches(shp, ITERS))
    assert ours == sorted(_smoke_rows(shp)[kernel])


def test_timed_shapes_are_the_smokes():
    shp = _shp("replica_room0_hash")
    assert (shp["track_rays"] * shp["samples"],
            shp["map_rays"] * shp["samples"],
            shp["map_rays"] * shp["probe_samples"]) == (80000, 168000, 134400)


def test_least_time_and_share():
    # 3.35 GB at 3.35 TB/s is 1 ms; 67 GFLOP at 67 TFLOP/s is 1 ms
    assert lib.least_s(3.35e9, 1.0) == pytest.approx(1e-3)
    assert lib.least_s(1.0, 67e9) == pytest.approx(1e-3)
    shp = _shp("replica_room0_hash")
    least = lib.kernel_work("scatter_accum", shp, ITERS)[0]
    run = {"shapes": shp, "trace": {
        "iters": ITERS, "kernels": {"void pass_a_kernel<2>(...)": [
            least * 1e6, 46], "void pass_b_kernel<2>": [least * 1e6, 46],
            "other": [1e9, 1]}}}
    assert lib.roofline(run, "scatter_accum") == pytest.approx(50.0)
    run["trace"]["iters"] = {"track": 5, "map": 0, "probe": 0}
    assert lib.roofline(run, "scatter_accum") is None
