#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`unislam_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 200] [--out chiprun_out]

Phases, in order; any failure ends the run with a non-zero exit:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every CUDA source of the port (one nvcc each, in
   parallel) and prints each kernel's register/spill report;
3. kernels: calls each kernel's wrapper at the SLAM loop's shapes, on
   points from a real frame of the scene below, holds it against its plain
   PyTorch version with the tolerances stated in `check_*`, checks that the
   scatter-accumulate is bitwise the same on a second run, and times the
   kernel, the plain version and (where one exists) the one PyTorch call
   that computes the same function:
   - hash (K1, K2, K9 at rows of 2): both hash grids, mapping N=168,000 and
     tracking N=80,000 points;
   - brick (K5, K6, K9 at rows of F=8): the four encode groups of
     configs/Replica/room0_tpu.yaml (mapping: 168,000 points at level 0
     and the 33,600 band points at levels 1-2; tracking: 80,000 points at
     levels 0-1 and the 16,000 band points at level 2), and K9 on the
     mapping backward's rows;
4. drives: the port's SLAM loop through `UniSLAM.step_frame` at full room0
   width on the room0-scale procedural scene (1200x680, fx=600, a 7.4 m
   room with a sphere, 0.75 degrees of orbit a frame), with only
   `mapping.bound` set to the scene's bound (and the frame prefetch thread
   off: the frames are rendered once, up front, for both drives). 200
   frames by default, the length of the JAX package's own room0-scale runs
   (examples/room0_scale_run.py), whose ATE rows in BASELINE.md the drives
   can be read against; the brick map's first 20-30 frames carry a
   tracking transient of several cm that a 12-frame ATE would be all of.
   Weights are random from seed 0. Each drive sets the launch counts to 0
   just before it and reads them just after; it prints per-frame and
   per-phase times, map+track rays/s and the ATE, and fails if the ATE is
   not finite or is above 3 cm, or if a kernel's launch count differs from
   what the executed iterations imply:
   - hash (configs/Replica/room0.yaml: 16-level hash grids of 2^16 / 2^19
     entries at 1 cm, 32+8 samples, tracking 2000 rays x 8 iterations,
     mapping 4000+200 rays x 15 iterations every 4th frame): per tracking
     iteration 2 x K1 and 2 x K2; per mapping iteration 2 x K1, 2 x K2 and
     2 x K9, plus one K1 per mapping iteration that ran the no-depth probe;
   - brick (configs/Replica/room0_tpu.yaml: 3-level brick ladder of 1,000
     dense and 16,384 / 65,536 hashed rows of 27x8 features, surface LOD
     with 8 band samples): per tracking iteration 2 x K5 and 2 x K6 (the
     coarse and the band group); per mapping iteration 2 x K5, 2 x K6 and
     1 x K9, plus one K5 per mapping iteration that ran the probe;
5. profile: after each drive, one tracked frame and one mapping phase under
   torch.profiler (device time by kernel, device busy share), written to
   --out.

Then it prints the `kernels` JSON line, the card line, and as its last line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_FLOPS = 67e12               # H100 SXM f32 rate outside tensor cores
ULP = 2.0 ** -24                # f32 unit round-off


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed(fn, device, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call: CUDA events around `iters` calls after warm-up.
    The device first spins for about 30 ms, so the host has queued the
    calls before the first one starts: a kernel shorter than its launch
    from Python then shows its device time, not the host's launch cost."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    torch.cuda._sleep(50_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def room0_setup(n_frames: int, config: str = "room0.yaml"):
    """A room0 config (configs/Replica/<config>) and the room0-scale
    procedural scene."""
    from unislam_tpu_torch.config import load_config, update_recursive
    from unislam_tpu_torch.data.synthetic import SyntheticRoom
    from unislam_tpu_torch.engine.slam import intrinsics_from_cfg

    cfg = load_config(os.path.join(REPO, "configs/Replica", config),
                      os.path.join(REPO, "configs/UNISLAM.yaml"))
    ds = SyntheticRoom(n_frames=n_frames, intr=intrinsics_from_cfg(cfg),
                       half=3.5, orbit_r=1.2, sphere_c=(1.0, -1.0, 0.0),
                       sphere_r=0.8, texture="noise", deg_per_frame=0.75)
    # the drive hands UniSLAM frames rendered up front, so a prefetch
    # thread would only add a hop to every fetch
    update_recursive(cfg, {"mapping": {"bound": ds.bound},
                           "profiling": {"enabled": True},
                           "data": {"prefetch": False}})
    return cfg, ds


def main_path_points(cfg, ds, n_rays: int, device, seed: int,
                     n_band: int = 0):
    """Normalised sample points of `n_rays` rays of frame 0, drawn and
    depth-guided as the renderer does: (n_rays * 40, 3); and with `n_band`
    the surface-LOD band, the n_band samples per ray nearest the depth
    (n_rays * n_band, 3)."""
    import torch
    from unislam_tpu_torch.core import rays as rays_lib
    from unislam_tpu_torch.core import rng, sampling
    from unislam_tpu_torch.models import scene as scene_lib

    sc = scene_lib.make_scene_config(cfg)
    color, depth, c2w = ds[0]
    g = rng.generator(seed, device)
    depth = torch.as_tensor(depth, device=device)
    color = torch.as_tensor(color, device=device)
    intr = ds.intr
    i, j, gd, _ = rays_lib.sample_pixels(n_rays, 0, intr.H, 0, intr.W, depth,
                                         color, g)
    o, d = rays_lib.rays_from_uv(i, j, torch.as_tensor(c2w, device=device),
                                 intr)
    r = cfg["rendering"]
    z = sampling.z_vals_with_depth(gd, sc.truncation, r["n_stratified"],
                                   r["n_importance"], True, g)
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    p_nor = scene_lib.normalize_points(sc, pts)
    band = None
    if n_band:
        sel = scene_lib.top_k_indices(-(z - gd[:, None]).abs(), n_band)
        band = torch.gather(p_nor, 1, sel[..., None].expand(-1, -1, 3))
        band = band.reshape(-1, 3).contiguous()
    return p_nor.reshape(-1, 3).contiguous(), sc, band


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions

def check_scatter(idx, rows, n_rows: int, tag: str, device) -> dict:
    """K9 on a backward's table-gradient rows: bitwise equal to the plain
    version (both sum each destination's updates one by one in f32, in
    stable sorted order, so no rounding may differ) and bitwise equal to
    itself on a second run. `library_ms` is `index_add_` (atomics)."""
    import torch
    from unislam_tpu_torch.kernels import build
    from unislam_tpu_torch.kernels.scatter_accum import (
        scatter_accumulate, scatter_accumulate_plain)

    M, D = rows.shape
    acc_k = scatter_accumulate(idx, rows, n_rows)
    acc_k2 = scatter_accumulate(idx, rows, n_rows)
    acc_p = scatter_accumulate_plain(idx, rows, n_rows)
    counts = scatter_accumulate_plain(idx, torch.ones_like(rows[:, :1]),
                                      n_rows)
    err = (acc_k - acc_p).abs()
    if not torch.equal(acc_k, acc_k2):
        raise AssertionError(f"K9 {tag}: not bitwise reproducible")
    if not torch.equal(acc_k, acc_p):
        raise AssertionError(f"K9 {tag}: differs from the plain version, "
                             f"max err {float(err.max())}")
    nb = M * 4 + M * D * 4 + n_rows * D * 4
    b, by = bound_ms(nb, M * D)
    rec = {
        "shape": f"{tag} M={M} D={D} rows={n_rows}",
        "max_abs_err": float(err.max()), "bitwise_repeat": True,
        "longest_run": int(counts.max()),
        "ms": timed(lambda: scatter_accumulate(idx, rows, n_rows), device),
        "plain_ms": timed(lambda: scatter_accumulate_plain(idx, rows, n_rows),
                          device, iters=5),
        "library_ms": timed(lambda: torch.zeros(
            n_rows, D, device=device).index_add_(0, idx, rows), device),
        "bound_ms": b, "bound_by": by, "bytes": nb}
    keys, order = torch.sort(idx, stable=True)
    rows_s = rows.index_select(0, order).contiguous()
    out = torch.zeros(n_rows, D, device=device)
    lib = build.library("scatter_accum")
    fn = lib.scatter_accumulate_sorted
    rec["sort_permute_ms"] = timed(lambda: rows.index_select(
        0, torch.sort(idx, stable=True)[1]), device)
    rec["kernel_only_ms"] = timed(lambda: fn(
        build.ptr(keys), build.ptr(rows_s), M, D, n_rows, build.ptr(out),
        build.stream_ptr(device)), device)
    return rec


def check_kernels(cfg, ds, device, n_map: int, n_track: int):
    """Returns {kernel: [per-shape record, ...]}; raises on disagreement.

    Tolerances:
    - K1 forward: |kernel - plain| <= 16 u * sum_k w_k |f_k| per output
      (the two sum 8 rounded products in possibly different orders);
    - K2 backward: destination rows equal exactly, row values within
      4 u relative, point gradient within 1e-4 relative plus 1e-5 of its
      largest magnitude (a 16-level sum with cancellation, both f32);
    - K9: as `check_scatter`."""
    import torch
    from unislam_tpu_torch.models import hash_encoding as he

    results = {"hash_encode_fwd": [], "hash_encode_bwd": [],
               "scatter_accumulate": []}
    gen = torch.Generator().manual_seed(1)
    pts_by_phase = {}
    for phase, n_rays, seed in (("map", n_map, 11), ("track", n_track, 12)):
        pts_by_phase[phase], sc, _ = main_path_points(cfg, ds, n_rays,
                                                      device, seed)
    for grid, spec in (("sdf", sc.sdf_spec), ("color", sc.color_spec)):
        table = he.init_table(spec, gen, device)
        T, L = spec.total_entries, spec.n_levels
        for phase, pts in pts_by_phase.items():
            N = pts.shape[0]
            tag = f"{grid}/{phase} N={N}"
            # --- K1
            out_k = he.encode_fwd(table, pts, spec)
            out_p = he.encode_fwd_plain(table, pts, spec)
            ref_abs = he.encode_fwd_plain(table.abs(), pts, spec)
            err = (out_k - out_p).abs()
            if not bool(torch.isfinite(out_k).all()) or \
                    bool((err > 16 * ULP * ref_abs).any()):
                raise AssertionError(f"K1 {tag}: max err {float(err.max())}")
            nb = N * 12 + T * 8 + N * L * 8
            b, by = bound_ms(nb, N * L * 8 * 4)
            results["hash_encode_fwd"].append({
                "shape": tag, "max_abs_err": float(err.max()),
                "ms": timed(lambda: he.encode_fwd(table, pts, spec), device),
                "plain_ms": timed(lambda: he.encode_fwd_plain(table, pts,
                                                              spec), device),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "bytes": nb})
            # --- K2 (mapping emits table rows; tracking only the points)
            g_out = torch.randn(N, spec.out_dim, generator=gen).to(device)
            rows_wanted = phase == "map"
            gp_k, ri_k, rv_k = he.encode_bwd(table, pts, g_out, spec, True,
                                             rows_wanted)
            gp_p, ri_p, rv_p = he.encode_bwd_plain(table, pts, g_out, spec,
                                                   True, rows_wanted)
            err_gp = (gp_k - gp_p).abs()
            tol_gp = 1e-4 * gp_p.abs() + 1e-5 * float(gp_p.abs().max())
            errs = [float(err_gp.max())]
            bad = not bool(torch.isfinite(gp_k).all()) or \
                bool((err_gp > tol_gp).any())
            if rows_wanted:
                bad |= not torch.equal(ri_k, ri_p)
                err_rv = (rv_k - rv_p).abs()
                errs.append(float(err_rv.max()))
                bad |= bool((err_rv > 4 * ULP * rv_p.abs()).any())
            if bad:
                raise AssertionError(f"K2 {tag}: max errs {errs}, rows "
                                     "equal: " + str(
                                         rows_wanted and torch.equal(ri_k,
                                                                     ri_p)))
            nb = N * 12 + N * L * 8 + T * 8 + N * 12
            if rows_wanted:
                nb += N * L * 8 * (4 + 8)
            b, by = bound_ms(nb, N * L * 8 * 12)
            results["hash_encode_bwd"].append({
                "shape": tag + (" +rows" if rows_wanted else ""),
                "max_abs_err": max(errs),
                "ms": timed(lambda: he.encode_bwd(table, pts, g_out, spec,
                                                  True, rows_wanted), device),
                "plain_ms": timed(lambda: he.encode_bwd_plain(
                    table, pts, g_out, spec, True, rows_wanted), device,
                    iters=5),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "bytes": nb})
            if not rows_wanted:
                continue
            # --- K9 on the rows K2 emitted
            results["scatter_accumulate"].append(check_scatter(
                ri_k, rv_k, T, f"{grid}/{phase}", device))
            del rv_k, ri_k, rv_p, ri_p
    return results


def check_brick_kernels(cfg, ds, device, n_map: int, n_track: int):
    """K5, K6 and K9 at the four encode groups of the brick drive (points
    from frame 0, the band as the renderer selects it), on a brick table
    from seed 1. Returns {kernel: [per-shape record, ...]}; raises on
    disagreement.

    Tolerances:
    - K5 forward: |kernel - plain| <= 16 u * sum_v w_v |f_v| per output
      (the same 8 rounded products, summed in possibly another order);
    - K6 backward: table-gradient destinations and values bitwise equal
      (both form bf16(bf16(w) * bf16(g)) from the same f32 weights); point
      gradient within 1e-4 relative plus 1e-5 of its largest magnitude
      (sums with cancellation, both f32);
    - K9 on the mapping backward's rows (both groups in one call, as the
      backward makes it): as `check_scatter`.

    Bound: the bytes the call must move, each input read once and each
    output written once, where the table counts only the distinct vertex
    F-vectors this call's points touch."""
    import torch
    from unislam_tpu_torch.models import brick_encoding as be

    results = {"brick_encode_fwd": [], "brick_encode_bwd": [],
               "scatter_accumulate": []}
    n_fine = cfg["rendering"]["n_fine"]
    gen = torch.Generator().manual_seed(1)
    groups = []
    for phase, n_rays, seed, split in (
            ("map", n_map, 11, cfg["rendering"]["lod_split"]),
            ("track", n_track, 12, cfg["tracking"]["lod_split"])):
        pts, sc, band = main_path_points(cfg, ds, n_rays, device, seed,
                                         n_fine)
        coarse, fine = be.coarse_fine_split(sc.brick_spec, split)
        groups += [(phase, "coarse", pts, coarse), (phase, "band", band, fine)]
    spec = sc.brick_spec
    table = be.init_table(spec, gen, device)
    F = spec.n_features
    map_idx, map_rows = [], []
    for phase, name, pts, levels in groups:
        N, L = pts.shape[0], len(levels)
        tag = f"{phase}/{name} N={N} levels={list(levels)}"
        vidx, _ = be._footprint(spec, pts, levels)
        touched = int(torch.unique(vidx).numel()) * F * 4
        # --- K5
        out_k = be.encode_fwd(table, pts, spec, levels)
        out_p = be.encode_fwd_plain(table, pts, spec, levels)
        ref_abs = be.encode_fwd_plain(table.abs(), pts, spec, levels)
        err = (out_k - out_p).abs()
        if not bool(torch.isfinite(out_k).all()) or \
                bool((err > 16 * ULP * ref_abs).any()):
            raise AssertionError(f"K5 {tag}: max err {float(err.max())}")
        nb = N * 12 + touched + N * L * F * 4
        b, by = bound_ms(nb, N * L * (8 * 2 * F + 16))
        results["brick_encode_fwd"].append({
            "shape": tag, "max_abs_err": float(err.max()),
            "ms": timed(lambda: be.encode_fwd(table, pts, spec, levels),
                        device),
            "plain_ms": timed(lambda: be.encode_fwd_plain(table, pts, spec,
                                                          levels), device),
            "bound_ms": b, "bound_by": by, "library_ms": None, "bytes": nb})
        # --- K6 (mapping emits table rows; tracking only the points)
        g_out = torch.randn(N, L * F, generator=gen).to(device)
        rows_wanted = phase == "map"
        gp_k, ri_k, rv_k = be.encode_bwd(table, pts, g_out, spec, levels,
                                         True, rows_wanted)
        gp_p, ri_p, rv_p = be.encode_bwd_plain(table, pts, g_out, spec,
                                               levels, True, rows_wanted)
        err_gp = (gp_k - gp_p).abs()
        tol_gp = 1e-4 * gp_p.abs() + 1e-5 * float(gp_p.abs().max())
        bad = not bool(torch.isfinite(gp_k).all()) or \
            bool((err_gp > tol_gp).any())
        if rows_wanted:
            rows_equal = torch.equal(ri_k, ri_p) and torch.equal(rv_k, rv_p)
            bad |= not rows_equal
            map_idx.append(ri_k)
            map_rows.append(rv_k)
        if bad:
            raise AssertionError(f"K6 {tag}: point gradient max err "
                                 f"{float(err_gp.max())}, rows bitwise "
                                 f"equal: {rows_wanted and rows_equal}")
        nb = N * 12 + N * L * F * 4 + touched + N * 12
        if rows_wanted:
            nb += N * L * 8 * (4 + F * 4)
        b, by = bound_ms(nb, N * L * (8 * 3 * F + 72))
        results["brick_encode_bwd"].append({
            "shape": tag + (" +rows" if rows_wanted else ""),
            "max_abs_err": float(err_gp.max()),
            "ms": timed(lambda: be.encode_bwd(table, pts, g_out, spec, levels,
                                              True, rows_wanted), device),
            "plain_ms": timed(lambda: be.encode_bwd_plain(
                table, pts, g_out, spec, levels, True, rows_wanted), device,
                iters=5),
            "bound_ms": b, "bound_by": by, "library_ms": None, "bytes": nb})
        del rv_p, ri_p
    # --- K9 on the mapping backward's rows, one call for both groups
    results["scatter_accumulate"].append(check_scatter(
        torch.cat(map_idx), torch.cat(map_rows), spec.total_rows * 27,
        "brick/map", device))
    return results


# ---------------------------------------------------------------------------
# phase 4: the SLAM drives

def drive(cfg, frame_list, device):
    """`UniSLAM.step_frame` over the frames; the launch counts are set to
    0 just before and read just after. A frame's line is printed every
    10th frame (all are in the JSON file)."""
    import numpy as np
    import torch
    from unislam_tpu_torch.engine.slam import UniSLAM
    from unislam_tpu_torch.kernels import build
    from unislam_tpu_torch.tools.eval_ate import pose_evaluation

    n_frames = len(frame_list)
    slam = UniSLAM(cfg, frame_list, seed=0, device=device)
    frames = []
    build.reset_launches()
    t_start = time.perf_counter()
    for idx in range(n_frames):
        t0 = time.perf_counter()
        mapped = slam.step_frame(idx)
        torch.cuda.synchronize(device)
        rec = slam.stats.frames[-1]
        err = float(np.linalg.norm(slam.est_c2w[idx][:3, 3]
                                   - slam.gt_c2w[idx][:3, 3]))
        frames.append({"idx": idx, "ms": (time.perf_counter() - t0) * 1e3,
                       "phases_ms": {k: v * 1e3 for k, v in
                                     rec["phases"].items()},
                       "t_iters": rec["t_iters"], "mapped": mapped,
                       "err_cm": err * 100})
        if idx % 10 == 0 or idx == n_frames - 1:
            print("frame " + json.dumps(frames[-1]), flush=True)
    wall_s = time.perf_counter() - t_start
    launches = dict(build.LAUNCHES)
    _, ate = pose_evaluation(slam.gt_c2w, slam.est_c2w)
    slam.close()
    return slam, frames, launches, ate, wall_s


def drive_report(slam, frames, launches, ate, wall_s):
    """Drive metrics. The `*_steady` ones leave out frame 0, whose mapping
    phase (the first, 10 iterations) also pays the one-time set-up of the
    CUDA libraries and the caching allocator."""
    st = slam.stats
    it = dict(slam.iters_run)
    track_ms = [f["phases_ms"]["tracking"] for f in frames
                if "tracking" in f["phases_ms"]]
    map_ms = [f["phases_ms"]["mapping"] for f in frames
              if "mapping" in f["phases_ms"]]
    t_s = st.time_s["tracking"] + st.time_s["mapping"]
    rays = st.rays["tracking"] + st.rays["mapping"]
    mc = slam.mc
    first_rays = mc.iters_first * (mc.pixels + mc.extra_rays)
    if slam.sc.encoding == "brick":
        # a render is one encode_multi of two groups (the coarse levels at
        # every sample, the fine levels at the band); the probe encodes the
        # coarse levels without a backward; one K9 per mapping backward
        expected = {"brick_encode_fwd": 2 * (it["track"] + it["map"])
                    + it["probe"],
                    "brick_encode_bwd": 2 * (it["track"] + it["map"]),
                    "scatter_accumulate": it["map"]}
    else:
        # one encode per hash grid (SDF, color) per render
        expected = {"hash_encode_fwd": 2 * (it["track"] + it["map"])
                    + it["probe"],
                    "hash_encode_bwd": 2 * (it["track"] + it["map"]),
                    "scatter_accumulate": 2 * it["map"]}
    return {
        "frames": len(frames), "iters_run": it,
        "tracked_frame_ms_mean": sum(track_ms) / len(track_ms),
        "tracked_frame_ms": track_ms,
        "tracking_ms_per_iter": st.time_s["tracking"] * 1e3 / it["track"],
        "mapping_phase_ms_mean": sum(map_ms) / len(map_ms),
        "mapping_phase_ms_steady": sum(map_ms[1:]) / max(len(map_ms) - 1, 1),
        "mapping_phase_ms": map_ms,
        "mapping_ms_per_iter": st.time_s["mapping"] * 1e3 / it["map"],
        "map_track_rays_per_s": rays / t_s,
        "map_track_rays_per_s_steady": (rays - first_rays)
        / (t_s - map_ms[0] / 1e3),
        "phase_wall_s": dict(st.time_s), "drive_wall_s": wall_s,
        "ate_cm": ate, "launches": launches, "launches_expected": expected,
    }


# ---------------------------------------------------------------------------
# phase 5: profile

def profile(slam, frame_list, device, out_dir: str, tag: str):
    """One tracked frame and one mapping phase under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    idx = slam.n_img - 1
    color, depth, _ = frame_list[idx]
    color = torch.as_tensor(color, device=device)
    depth = torch.as_tensor(depth, device=device)
    report = {}
    for name, fn in ((f"{tag}_tracked_frame",
                      lambda: slam.track_frame(idx, depth, color)),
                     (f"{tag}_mapping_phase",
                      lambda: slam.map_frame(idx, depth, color))):
        torch.cuda.synchronize(device)
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        # kernel rows only: an operator's or an annotation's row repeats
        # its kernels' time
        rows = sorted(((e.self_device_time_total, e.key, e.count)
                       for e in events if e.device_type == DeviceType.CUDA
                       and not e.is_user_annotation), reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3

        def count(*keys):
            return sum(e.count for e in events if e.key in keys)

        report[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                        "device_idle_share": 1.0 - busy_ms / wall_ms,
                        # each sync makes the host wait for the device
                        "host_syncs": count("cudaStreamSynchronize",
                                            "cudaDeviceSynchronize"),
                        "kernel_launches": count("cudaLaunchKernel",
                                                 "cudaLaunchKernelExC",
                                                 "cuLaunchKernel"),
                        "top": [{"kernel": k[:90], "device_ms": us / 1e3,
                                 "calls": c} for us, k, c in rows[:14]]}
        prof.export_chrome_trace(os.path.join(out_dir,
                                              f"trace_{name}.json.gz"))
    return report


# ---------------------------------------------------------------------------

KERNELS = {
    "hash_encode_fwd": ("unislam_tpu_torch/csrc/hash_encode.cu",
                        "unislam_tpu/models/hash_encoding.py:154"),
    "hash_encode_bwd": ("unislam_tpu_torch/csrc/hash_encode.cu",
                        "unislam_tpu/models/hash_encoding.py:170"),
    "scatter_accumulate": ("unislam_tpu_torch/csrc/scatter_accum.cu",
                           "examples/pallas_scatter_accum.py:122"),
    "brick_encode_fwd": ("unislam_tpu_torch/csrc/brick_encode.cu",
                         "examples/pallas_fused_dense.py:169"),
    "brick_encode_bwd": ("unislam_tpu_torch/csrc/brick_encode.cu",
                         "examples/pallas_fused_dense.py:212"),
}
# the shape whose times head the `kernels` line (all are in the JSON file)
HEADLINE = {"hash_encode_fwd": "color/map", "hash_encode_bwd": "color/map",
            "scatter_accumulate": "brick/map", "brick_encode_fwd": "map/coarse",
            "brick_encode_bwd": "map/coarse"}


def run_drive(name, cfg, frame_list, device, out_dir):
    """One drive and its profile; raises if the drive misses its bars."""
    slam, frames, launches, ate, wall_s = drive(cfg, frame_list, device)
    rep = drive_report(slam, frames, launches, ate, wall_s)
    print(f"drive {name} " + json.dumps(
        {k: v for k, v in rep.items()
         if k not in ("tracked_frame_ms", "mapping_phase_ms")}), flush=True)
    ate_cm = ate["error.rmse"]
    if not math.isfinite(ate_cm) or ate_cm >= 3.0:
        raise AssertionError(f"drive {name}: ATE-RMSE {ate_cm} cm (bar: "
                             "< 3 cm)")
    if launches != rep["launches_expected"]:
        raise AssertionError(f"drive {name}: launches {launches} != "
                             f"expected {rep['launches_expected']}")
    prof = profile(slam, frame_list, device, out_dir, name)
    for pname, r in prof.items():
        print(f"profile {pname} " + json.dumps(r), flush=True)
    return rep, frames, prof


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from unislam_tpu_torch.kernels import build

    device = torch.device("cuda")
    os.makedirs(args.out, exist_ok=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    print("torch " + torch.__version__ + " cuda " + str(torch.version.cuda),
          flush=True)

    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    setups = {"hash": room0_setup(args.frames, "room0.yaml"),
              "brick": room0_setup(args.frames, "room0_tpu.yaml")}
    t0 = time.perf_counter()
    kern = {}
    for name, check in (("hash", check_kernels),
                        ("brick", check_brick_kernels)):
        cfg, ds = setups[name]
        n_map = cfg["mapping"]["pixels"] + 200
        n_track = cfg["tracking"]["pixels"]
        for kname, recs in check(cfg, ds, device, n_map, n_track).items():
            kern.setdefault(kname, []).extend(recs)
            for r in recs:
                print(f"kernel {kname} " + json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    print(f"kernels: checked in {time.perf_counter() - t0:.1f} s", flush=True)

    # both drives run on the same frames, rendered once up front: the
    # procedural render is host numpy work that would otherwise compete
    # with the driver for the interpreter
    t0 = time.perf_counter()
    ds = setups["hash"][1]
    frame_list = [ds[i] for i in range(args.frames)]
    print(f"render: {args.frames} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    drives, frames, prof = {}, {}, {}
    for name, (cfg, _) in setups.items():
        drives[name], frames[name], p = run_drive(name, cfg, frame_list,
                                                  device, args.out)
        prof.update(p)
        torch.cuda.empty_cache()

    line = []
    for name, (src, replaces) in KERNELS.items():
        recs = kern[name]
        head = next(r for r in recs if r["shape"].startswith(HEADLINE[name]))
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": sum(d["launches"].get(name, 0)
                                     for d in drives.values()),
                     "max_abs_err": max(r["max_abs_err"] for r in recs),
                     "ms": head["ms"], "plain_ms": head["plain_ms"],
                     "bound_ms": head["bound_ms"],
                     "bound_by": head["bound_by"],
                     "library_ms": head["library_ms"],
                     "shape": head["shape"]})
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kern, "drives": drives,
                   "frames": frames, "profile": prof}, f, indent=1)
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
