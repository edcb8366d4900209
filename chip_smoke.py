#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`unislam_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 200] [--out DIR]

Phases, in order; any failure ends the run with a non-zero exit:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every CUDA source of the port (one nvcc each, in
   parallel) and prints each kernel's register/spill report;
3. kernels: calls each kernel's wrapper at the SLAM loop's shapes, on
   points from a real frame of the scene below, holds it against its plain
   PyTorch version with the tolerances stated in `check_*`, checks that the
   fixed-point scatter-accumulate is bitwise the same on a second run and
   on shuffled rows and within its bound of a float64 sum, and times the
   kernel (K9 also pass by pass), the plain version and (where one exists)
   the one PyTorch call that computes the same function (the tolerances
   are stated in `check_*`):
   - hash (K1, K2, K9 at rows of 2): both hash grids, mapping N=168,000
     (K2 with table rows) and tracking N=80,000 points (K2 points only);
   - brick (K5, K6, K9 at rows of F=8): the four encode groups of
     configs/Replica/room0_tpu.yaml (mapping: 168,000 points at level 0
     and the 33,600 band points at levels 1-2; tracking: 80,000 points at
     levels 0-1 and the 16,000 band points at level 2), K5 also grouped as
     `encode_multi` launches it (the map and the track pair in one launch
     each, bitwise equal to the group-by-group launches, timed beside
     them), K5 at the no-depth probe's shape (the 4,200 mapping rays'
     32 uniform samples to the far bound, 134,400 points at level 0, the
     coarse level of the mapping split), and K9 on the mapping backward's
     rows;
   - K9 also on each backward's rows with NaN and +-inf terms put in
     (`check_scatter_non_finite`: per-column IEEE classes, bitwise equal
     to the plain version in two row orders);
   - K1 and K5 at the shapes of meshing and `render_img`
     (`check_inference_kernels`: a 500,000-point SDF batch of the 1 cm
     grid, a 10,000-ray render chunk);
   - K4, the fused bf16 decoder (`check_k4`): forward, backward with and
     without weight gradients, at the brick decoder's shapes (both heads
     in one launch: mapping, tracking, a render chunk) and the hash SDF
     head's (mapping, a mesh batch), and at adversarial features; within
     `k4_misfit` of the plain version, the backward bitwise on a repeat;
     the check must fail the plain version with one rounding point taken
     out, or with d rounded to bf16 as well (`k4_control`); the weight
     gradients (f32 sums out of the kernel) rounded to bf16 as the mapper
     rounds them (`k4_outputs`);
   - K7, bf16-state Adam (`check_k7`): the brick and both hash tables,
     several step counts and lr scales, NaN and inf inputs, bitwise equal
     to the plain version; and on each table's second row block with its
     element offset (`parallel.shard_tables`), bitwise equal to the plain
     version with that offset and to the same rows of a whole-table step;
   - K8, the band row dedup (`check_k8`): the brick map's band rows at
     Ku = 4 and 8, with NaN and +-inf terms put in, and hand-made rays;
     bitwise equal to the plain version (but for the sign of zero) and on
     a repeat; K9 on the deduped rows beside K9 on the rows without it;
     the share of rays that overflow Ku and of the band gradient dropped;
   - K3, compositing (`check_k3`): forward at the tracking, mapping and
     `render_img` chunk shapes, probe mode at the mapping shape, backward
     with the loop's cotangents and with all five, and adversarial rays
     (saturated alpha, all-zero weights, NaN sdf; R = 0); within
     `k3_misfit` of the plain version, bitwise on a repeat;
4. drives: the port's SLAM loop through `UniSLAM.step_frame` at full room0
   width on the room0-scale procedural scene (1200x680, fx=600, a 7.4 m
   room with a sphere, 0.75 degrees of orbit a frame), with only
   `mapping.bound` (and marching_cubes_bound) set to the scene's bound (and
   the frame prefetch thread off: the frames are rendered once, up front,
   for every drive). 200 frames by default, as the JAX package's own
   room0-scale runs take (examples/room0_scale_run.py); the brick map's
   first 20-30 frames carry a tracking transient of several cm that a
   12-frame ATE would be all of.
   Weights are random from seed 0. Each drive sets the launch counts to 0
   just before it and reads them just after; it prints per-frame and
   per-phase times, map+track rays/s and the ATE, and fails if the ATE is
   not finite or is above its bar (`ATE_BAR_CM`), or if a kernel's
   launch count differs from what the executed iterations imply. In every
   drive K3 launches one forward and one backward a tracking or mapping
   iteration, and one forward (probe mode) a probe iteration:
   - hash (configs/Replica/room0.yaml: 16-level hash grids of 2^16 / 2^19
     entries at 1 cm, 32+8 samples, tracking 2000 rays x 8 iterations,
     mapping 4000+200 rays x 15 iterations every 4th frame): per tracking
     iteration 2 x K1 and 2 x K2; per mapping iteration 2 x K1, 2 x K2 and
     2 x K9, plus one K1 per mapping iteration that ran the no-depth probe;
   - hash_holes: the hash drive on frames with depth holes
     (`depth_holes`: 16x16 blocks over 5% of each frame's depth zeroed,
     colour kept), so every mapping iteration runs the
     no-depth probe (one more K1 and one K3 probe launch); it fails if the
     probe never ran. Its ATE bar is the larger of 3 cm and the JAX
     package's median over four seeds of the same drive (`ATE_BAR_CM`);
   - brick (configs/Replica/room0_tpu.yaml: 3-level brick ladder of 1,000
     dense and 16,384 / 65,536 hashed rows of 27x8 features, surface LOD
     with 8 band samples): per tracking iteration 1 x K5 (one launch for
     the coarse and the band group) and 2 x K6 (one per group); per mapping
     iteration 1 x K5, 2 x K6 and 1 x K9, plus one K5 per mapping
     iteration that ran the probe;
   - brick_lowp: the brick drive with both low-precision mapping options
     (`LOWP`: grid.tcnn_network, the fused bf16 decoders; and
     mapping.adam_state_dtype bfloat16, bf16-state Adam for the table):
     the brick drive's launches plus, per tracking or mapping iteration,
     one K4 forward (both heads) and one K4 backward (weight gradients in
     mapping only), one K4 forward per probe iteration, and one K7 per
     mapping iteration. Its ATE bar is the JAX package's median over
     four seeds of the same drive (`ATE_BAR_CM`);
   - brick_dedup: the brick drive with the band row dedup
     (`DEDUP`: rendering.dedup_band 1.0, so Ku = K and no run is
     dropped): the brick drive's launches plus one K8 per band group per
     mapping iteration (one group here) and none in tracking. Its ATE bar
     is the larger of 3 cm and the JAX package's median over four seeds
     of the same drive (`ATE_BAR_CM`);
   - brick_holes: the brick drive on the hash_holes frames, so every
     mapping iteration runs the brick loop's no-depth probe (one more K5
     on the coarse levels and one K3 probe launch); it fails unless the
     probe ran in every mapping iteration. Its ATE bar is the larger of 3
     cm and the JAX package's median over four seeds of the same drive
     (`ATE_BAR_CM`);
5. profile: after each drive, one tracked frame and one mapping phase under
   torch.profiler (device time by kernel, device busy share), written to
   --out;
6. mesh brick: the brick drive's final map through `Mesher` (LOD two-pass)
   and one full image through `render_img` (`mesh_and_render`; K5 and K3
   once a chunk, and once more a chunk with a pixel without depth). The mesh
   is at 4 cm here, not the config's 1 cm: at 1 cm the untrained fine
   levels in the part of the room the drive never saw make about 145M
   marching vertices, 745 s of host marching on the card's machine;
7. parallel (`parallel_phase`): the first 40 frames, written once to
   build/dp_frames for the ranks to map, and sequential 40-frame hash and
   20-frame brick_lowp runs as references; then
   - nccl_world1: `scripts/smoke_rank.py` as one rank on NCCL (the
     backend of a rank a card), 8 frames, bit for bit the sequential hash
     drive on the same 8 frames (one rank's collectives are identities);
   - dp_hash: room0.yaml with `parallel.data_parallel`, 2 ranks on this
     card on gloo (NCCL refuses two ranks on one GPU; gloo takes CUDA
     tensors through the host), each tracking 1,000 of the 2,000 rays
     and mapping 2,100 of the 4,200;
   - dp_brick: room0_tpu.yaml with the `LOWP` options, 2 ranks on gloo;
   - dp_brick_rows: dp_brick with `parallel.shard_tables`, each rank
     training half the brick table's rows (K7 with the block's element
     offset), bit for bit dp_brick: trajectory and final scene (on 2 ranks
     gloo's sum of two terms does not depend on their order, a gather adds
     -0.0, which keeps every value, and K7's row block is bitwise the
     whole table's rows); the pair fails unless a phase ran joint BA
     (the last, at frame 19, with 5 keyframes);
   - overlap_hash: `OverlappedSLAM` with tracking and mapping on this card,
     in this process;
   - overlap_dp_hash: room0.yaml under `DistributedOverlappedSLAM`, 3
     gloo ranks of this card (`scripts/smoke_rank.py --overlap`): rank 0
     tracks all 2,000 rays of a frame, ranks 1-2 map 2,100 of the 4,200
     each, and rank 1 sends each phase's snapshot to rank 0.
   dp_hash runs the first 16 frames (DP_HASH_FRAMES), dp_brick and
   dp_brick_rows the first 20 (DP_BRICK_FRAMES), the overlapped drives the
   first 40 (DP_FRAMES).
   Each mapping rank holds its first mapping iteration (loss, every
   leaf's summed gradient) against a one-rank step on the same draws and,
   with row-sharded bf16-state tables, K7 on its block bitwise against K7
   on the whole table (`scripts/smoke_rank.py`); compares the replicas
   after every mapping phase; every rank reports its launches (exact, as
   `drive_report`'s formula gives them for the iterations it ran),
   timings and all-reduce bytes. The ranks' trajectories must be the same.
   dp_hash: every frame within 2 cm of the hash drive's first 16 frames,
   the ATE within 1 cm of theirs and at most 3 cm. overlap_hash and
   overlap_dp_hash: the ATE within 1 cm of the hash drive's first 40
   frames' and at most 3 cm.
   dp_brick and dp_brick_rows: their distance to the sequential
   brick_lowp run on the same frames is reported, not held: a change of
   summation order moves that run by several cm in these frames
   (scripts/trajectory_sensitivity.py, PERF.md). The
   in-process overlapped driver must map as often as the sequential run
   and leave the loss and the BA pose pending after a mapping frame until
   `sync()`; in overlap_dp_hash the tracking rank launches no K9, no
   frame tracks a snapshot older than the previous phase's, every rank
   maps the same frames, those of the schedule (`frames_mapped_by_
   schedule`: the tracker's snapshot lags up to a phase there, so its
   uncertainty trigger, and with it the number of phases, may differ from
   the sequential run's, which is reported beside it;
   scripts/overlap_lag_witness.py shows the same count in one process),
   every rank drew as many seeds, and the tracker's snapshot after the
   final `sync()` is the mapping scene bit for bit.
   A gloo all-reduce through the host of one card is no scaling number;
8. cli: the port's CLI as a subprocess on the first 60 frames
   (CLI_FRAMES; 100 before the overlapped ranks' drive came), recorded in
   Replica's layout, hash room0, run and resume (`cli_drive`), meshing at
   2 cm (CLI_MESH_RES; at the config's 1 cm the two runs' final meshes
   took 116 s of the smoke on an H100 machine; 2 cm keeps the
   hierarchical pass, which the drive holds);
9. viewer: on the `cli` run's directory, `python -m
   unislam_tpu_torch.visualizer` as a subprocess (playback every 20th
   frame, with `--incremental`, with `--mp4`), the live follower once and
   the web viewer's routes (`viewer_phase`); host code, no device.

Then it prints its own wall time (`smoke: ... s`), the `parallel` JSON
line, the `kernels` JSON line (launches summed over every drive, rank and
run), the card line, and as its last line
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
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core rate
ULP = 2.0 ** -24                # f32 unit round-off
# the brick mesh's grid spacing (m); see phase 6 of the module note
BRICK_MESH_RES = 0.04
# the `cli` drive's frames (run 1 to 60% of them, then --resume), and its
# meshes (the config's is 0.01)
CLI_FRAMES = 60
CLI_MESH_RES = 0.02
# name prefixes of the kernels in unislam_tpu_torch/csrc
OUR_KERNELS = ("hash_", "brick_", "pass_", "fused_mlp", "adam_",
               "band_dedup", "composite_")


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


def bound_ms(n_bytes: float, n_flops: float, flops_rate: float = F32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing(kernel, plain, device, n_bytes: float, n_flops: float,
           plain_iters: int = 20, flops_rate: float = F32_FLOPS) -> dict:
    """A kernel record's times: the kernel's and its plain version's ms,
    and the bound for `n_bytes` moved and `n_flops` done (at `flops_rate`,
    the peak for the operations' type)."""
    b, by = bound_ms(n_bytes, n_flops, flops_rate)
    return {"ms": timed(kernel, device),
            "plain_ms": timed(plain, device, iters=plain_iters),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "bytes": n_bytes}


# the low-precision mapping options of the third drive
LOWP = {"grid": {"tcnn_network": True},
        "mapping": {"adam_state_dtype": "bfloat16"}}
# the band row dedup of the fourth drive, at Ku = K: no run is dropped
DEDUP = {"rendering": {"dedup_band": 1.0}}
# the depth holes of the *_holes drives: square blocks of HOLE_PX pixels
# covering HOLE_SHARE of the image
HOLE_PX = 16
HOLE_SHARE = 0.05


def depth_holes(depth, idx: int):
    """A copy of frame `idx`'s depth (H, W) with 0 (no sensor depth) in
    round(HOLE_SHARE * H * W / HOLE_PX^2) distinct HOLE_PX x HOLE_PX blocks
    of the block grid (blocks at the lower and right edges are cut by the
    image), drawn by `numpy.random.default_rng(idx)`: the dropouts of a
    structured-light sensor (ScanNet, TUM RGB-D). Pure numpy, so the JAX
    witness (scripts/holes_jax_witness.py) drops the same pixels."""
    import numpy as np

    depth = np.array(depth, dtype=np.float32, copy=True)
    H, W = depth.shape
    bh, bw = -(-H // HOLE_PX), -(-W // HOLE_PX)
    n = int(round(HOLE_SHARE * H * W / HOLE_PX ** 2))
    for b in np.random.default_rng(idx).choice(bh * bw, n, replace=False):
        r, c = divmod(int(b), bw)
        depth[r * HOLE_PX:(r + 1) * HOLE_PX, c * HOLE_PX:(c + 1) * HOLE_PX] = 0
    return depth


def with_holes(frame_list):
    """The frames with `depth_holes` in every depth; colour and pose kept."""
    return [(c, depth_holes(d, i), p) for i, (c, d, p) in
            enumerate(frame_list)]


def room0_setup(n_frames: int, config: str = "room0.yaml",
                overrides: dict | None = None):
    """A room0 config (configs/Replica/<config>, with `overrides`) and the
    room0-scale procedural scene."""
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
    update_recursive(cfg, {"mapping": {"bound": ds.bound,
                                       "marching_cubes_bound": ds.bound},
                           "profiling": {"enabled": True},
                           "data": {"prefetch": False}})
    update_recursive(cfg, overrides or {})
    return cfg, ds


def table_shapes(setups) -> dict:
    """The grid tables the drives train: name -> shape."""
    from unislam_tpu_torch.models import scene as scene_lib

    h = scene_lib.make_scene_config(setups["hash"][0])
    b = scene_lib.make_scene_config(setups["brick"][0]).brick_spec
    return {"brick table": (b.total_rows, b.row_dim),
            "hash sdf_table": (h.sdf_spec.total_entries, 2),
            "hash color_table": (h.color_spec.total_entries, 2)}


def frame0_rays(ds, n_rays: int, device, g):
    """`n_rays` rays of frame 0 drawn as the loop draws pixels, with
    generator `g`: (origins, directions, sensor depths)."""
    import torch
    from unislam_tpu_torch.core import rays as rays_lib

    color, depth, c2w = ds[0]
    intr = ds.intr
    i, j, gd, _ = rays_lib.sample_pixels(
        n_rays, 0, intr.H, 0, intr.W, torch.as_tensor(depth, device=device),
        torch.as_tensor(color, device=device), g)
    o, d = rays_lib.rays_from_uv(i, j, torch.as_tensor(c2w, device=device),
                                 intr)
    return o, d, gd


def main_path_points(cfg, ds, n_rays: int, device, seed: int,
                     n_band: int = 0, perturb: bool = True,
                     zsorted: bool = False):
    """Normalised sample points of `n_rays` rays of frame 0, drawn and
    depth-guided as the renderer does: (n_rays * 40, 3); and with `n_band`
    the surface-LOD band, the n_band samples per ray nearest the depth
    (n_rays * n_band, 3), nearest first or, `zsorted`, in z order as the
    band row dedup takes them. `perturb` False: the samples of
    `render_img`."""
    import torch
    from unislam_tpu_torch.core import rng, sampling
    from unislam_tpu_torch.models import scene as scene_lib

    sc = scene_lib.make_scene_config(cfg)
    g = rng.generator(seed, device)
    o, d, gd = frame0_rays(ds, n_rays, device, g)
    r = cfg["rendering"]
    z = sampling.z_vals_with_depth(gd, sc.truncation, r["n_stratified"],
                                   r["n_importance"], perturb, g)
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    p_nor = scene_lib.normalize_points(sc, pts)
    band = None
    if n_band:
        sel = scene_lib.top_k_indices(-(z - gd[:, None]).abs(), n_band)
        if zsorted:
            sel = torch.sort(sel, dim=-1).values
        band = torch.gather(p_nor, 1, sel[..., None].expand(-1, -1, 3))
        band = band.reshape(-1, 3).contiguous()
    return p_nor.reshape(-1, 3).contiguous(), sc, band


def probe_points(cfg, ds, n_rays: int, device, seed: int):
    """Normalised sample points of the no-depth probe on `n_rays` rays of
    frame 0, drawn as `renderer._probe_z_vals` draws them: the
    `rendering.n_stratified` perturbed uniform samples of each ray up to
    its exit from the scene's bound (+1 cm), (n_rays * n_stratified, 3)."""
    from unislam_tpu_torch.core import rays as rays_lib
    from unislam_tpu_torch.core import rng, sampling
    from unislam_tpu_torch.models import scene as scene_lib

    sc = scene_lib.make_scene_config(cfg)
    g = rng.generator(seed, device)
    o, d, _ = frame0_rays(ds, n_rays, device, g)
    far = rays_lib.ray_aabb_far(o, d, sc.bound_tensors(device)[0])
    z = sampling.z_vals_uniform(far, cfg["rendering"]["n_stratified"], True,
                                g)
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    return scene_lib.normalize_points(sc, pts.reshape(-1, 3)).contiguous()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions

# coordinates just outside [0, 1] (and -0.0, which is inside)
OUTSIDE = (-0.0, -1.0e-45, -1.0e-7, -0.01, -0.5, 1.0000001, 1.000001, 1.01,
           1.5)


def adversarial_points(kind: str, scales, seed: int = 0) -> dict:
    """Points where a re-laid kernel's index math or a contracted
    multiply-add goes wrong, as {group: (M, 3) float32}:

    - "faces": a coordinate on a cell face of some level under the kernels'
      position math, rounded twice (`kind` "hash": p*scale + 0.5 with
      `scales` the levels' scales; "brick": p*(res-1) - cell with `scales`
      the levels' res-1), within 8 ulps of (k-0.5)/scale or k/(res-1); the
      values where one fused multiply-add would round the position (hash)
      or frac (brick) otherwise are kept too. Each value sits on each axis
      in turn (the other two uniform), and triples of them make points on
      cell corners;
    - "bounds": coordinates exactly 0 or 1 (the cube's 8 corners, and 0 or
      1 on one or two axes);
    - "outside": coordinates just outside [0, 1] (`OUTSIDE`) on one axis,
      and on all three.

    Returns also "fma_flips", the number of those values whose position
    (hash) or frac (brick) an FMA would change."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = np.float32
    faces, flips = [], 0
    for s in np.asarray(scales, np.float32):
        top = int(s) if kind == "hash" else int(s) - 1
        for k in np.unique(rng.integers(1, top + 1, 6)):
            p0 = f32((k - 0.5) / s) if kind == "hash" else f32(k / s)
            p = (np.array([p0], f32).view(np.int32)
                 + np.arange(-8, 9, dtype=np.int32)).view(f32)
            p = p[(p >= 0.0) & (p <= 1.0)]
            exact = p.astype(np.float64) * np.float64(s)
            if kind == "hash":
                twice = (p * s).astype(f32) + f32(0.5)
                fused = (exact + 0.5).astype(f32)
                on_face = twice == np.floor(twice)
                flip = fused != twice
            else:
                pos = (p * s).astype(f32)
                cell = np.floor(pos)
                on_face = pos == cell
                flip = (exact - cell).astype(f32) != pos - cell
            flips += int(flip.sum())
            faces.append(p[on_face | flip])
    faces = np.unique(np.concatenate(faces))

    def on_axes(values):
        pts = []
        for a in range(3):
            x = rng.uniform(0.0, 1.0, (len(values), 3)).astype(f32)
            x[:, a] = values
            pts.append(x)
        return np.concatenate(pts)

    triples = rng.choice(faces, (len(faces), 3)).astype(f32)
    bits = (np.arange(8)[:, None] >> np.arange(3)[::-1]) & 1
    one_two = rng.uniform(0.0, 1.0, (48, 3)).astype(f32)
    for i, x in enumerate(one_two):
        axes = rng.choice(3, 1 + i % 2, replace=False)
        x[axes] = rng.integers(0, 2, len(axes))
    out = np.array(OUTSIDE, f32)
    return {
        "faces": np.concatenate([on_axes(faces), triples]),
        "bounds": np.concatenate([bits.astype(f32), on_axes(np.array(
            [0.0, 1.0] * 4, f32)), one_two]),
        "outside": np.concatenate([on_axes(out), np.stack(
            [out, out[::-1], np.roll(out, 3)], axis=1)]).astype(f32),
        "fma_flips": flips}


def adversarial_tensor(kind: str, scales, device):
    """All groups of `adversarial_points` as one (M, 3) tensor on
    `device`, and the (M, 3) mask of coordinates outside [0, 1], where the
    point gradient must be 0."""
    import numpy as np
    import torch

    adv = adversarial_points(kind, scales)
    pts = torch.as_tensor(np.concatenate(
        [adv[g] for g in ("faces", "bounds", "outside")])).to(device)
    return pts, (pts < 0.0) | (pts > 1.0)


def scatter_pass_ms(idx, rows, n_rows: int, calls: int = 5) -> dict:
    """K9's device time per pass (zeroing, A, B, C), from torch.profiler
    over `calls` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from unislam_tpu_torch.kernels.scatter_accum import scatter_accumulate

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            scatter_accumulate(idx, rows, n_rows)
        torch.cuda.synchronize()
    ms = {"zero": 0.0, "A": 0.0, "B": 0.0, "C": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = ("A" if "pass_a" in e.key else "B" if "pass_b" in e.key
                else "C" if "pass_c" in e.key else "zero")
        ms[name] += e.self_device_time_total / 1e3 / calls
    return ms


def check_scatter(idx, rows, n_rows: int, tag: str, device) -> dict:
    """K9 on a backward's table-gradient rows. Bitwise equal to the plain
    version (both take the same fixed-point steps, and an integer sum does
    not depend on its order), to itself on a second run and to itself on
    the rows in a shuffled order; within its bound of a float64
    `index_add_` sum: 1 f32 ulp + c_k 2^(e_k + h_k - 63) per destination
    (c_k terms, e_k the frexp exponent of the largest |term|, h_k =
    ceil(log2 c_k)), plus the f64 sum's own rounding, c_k 2^-52 sum|terms|.
    `library_ms` is `index_add_` (f32 atomics, order-dependent)."""
    import torch
    from unislam_tpu_torch.kernels.scatter_accum import (
        scatter_accumulate, scatter_accumulate_plain)

    M, D = rows.shape
    acc_k = scatter_accumulate(idx, rows, n_rows)
    if not torch.equal(acc_k, scatter_accumulate(idx, rows, n_rows)):
        raise AssertionError(f"K9 {tag}: not bitwise reproducible")
    perm = torch.randperm(M, generator=torch.Generator().manual_seed(3)).to(
        device)
    if not torch.equal(acc_k, scatter_accumulate(idx[perm], rows[perm],
                                                 n_rows)):
        raise AssertionError(f"K9 {tag}: differs on shuffled rows")
    del perm
    acc_p = scatter_accumulate_plain(idx, rows, n_rows)
    err = (acc_k - acc_p).abs()
    if not torch.equal(acc_k, acc_p):
        raise AssertionError(f"K9 {tag}: differs from the plain version, "
                             f"max err {float(err.max())}")
    del acc_p
    # the bound against a float64 sum
    i64 = idx.long()
    ref = torch.zeros(n_rows, D, dtype=torch.float64,
                      device=device).index_add_(0, i64, rows.double())
    abs_sum = torch.zeros_like(ref).index_add_(0, i64, rows.double().abs())
    count = torch.bincount(i64, minlength=n_rows)
    top = torch.zeros(n_rows, dtype=torch.int32, device=device)
    top.scatter_reduce_(0, i64, (rows.view(torch.int32) & 0x7FFFFFFF).amax(1),
                        "amax", include_self=True)
    del i64
    e = torch.frexp(top.view(torch.float32).double()).exponent
    h = torch.frexp((count - 1).clamp(min=0).double()).exponent
    ulp = torch.maximum(ref.abs().float(), acc_k.abs()).nextafter(
        torch.tensor(math.inf, device=device)) - torch.maximum(
            ref.abs().float(), acc_k.abs())
    c = count.double()[:, None]
    bound = (ulp.double() + c * torch.exp2((e + h - 63).double())[:, None]
             + c * 2.0 ** -52 * abs_sum)
    ratio = float(((acc_k.double() - ref).abs() / bound).max())
    if not ratio <= 1.0:
        raise AssertionError(f"K9 {tag}: {ratio} of its bound from the f64 "
                             "sum")
    del ref, abs_sum, top, ulp, bound
    nb = M * 4 + M * D * 4 + n_rows * D * 4
    b, by = bound_ms(nb, M * D)
    return {
        "shape": f"{tag} M={M} D={D} rows={n_rows}",
        "max_abs_err": float(err.max()), "bitwise_repeat": True,
        "bitwise_shuffled": True, "share_of_bound_vs_f64": ratio,
        "longest_run": int(count.max()),
        "ms": timed(lambda: scatter_accumulate(idx, rows, n_rows), device),
        "pass_ms": scatter_pass_ms(idx, rows, n_rows),
        "plain_ms": timed(lambda: scatter_accumulate_plain(idx, rows, n_rows),
                          device, iters=5),
        "library_ms": timed(lambda: torch.zeros(
            n_rows, D, device=device).index_add_(0, idx, rows), device),
        "bound_ms": b, "bound_by": by, "bytes": nb}


def check_scatter_non_finite(idx, rows, n_rows: int, tag: str,
                             device) -> dict:
    """K9 on a backward's rows with non-finite terms put in: a NaN, a +inf
    and a -inf each in about one row of 1,000, and one destination that
    receives both a +inf and a -inf in one column. The kernel must equal
    its plain version bit for bit (NaN bits included), in the given and in
    a shuffled row order, and give IEEE classes per column: NaN where a NaN
    or both infinities came in, +-inf where only one sign did, and the
    finite columns of those destinations equal to the all-finite sum's."""
    import torch
    from unislam_tpu_torch.kernels.scatter_accum import (
        scatter_accumulate, scatter_accumulate_plain)

    M, D = rows.shape
    gen = torch.Generator().manual_seed(5)
    rows = rows.clone()
    pick = torch.randperm(M, generator=gen)[:3 * (M // 1000) + 2].to(device)
    n = M // 1000
    col = torch.randint(0, D, (len(pick),), generator=gen).to(device)
    vals = torch.cat([torch.full((n,), float("nan")),
                      torch.full((n,), float("inf")),
                      torch.full((n + 2,), float("-inf"))]).to(device)
    # the last two picks: +inf and -inf into one (destination, column)
    both = pick[-2:]
    idx = idx.clone()
    idx[both[1]] = idx[both[0]]
    col[-1] = col[-2]
    vals[-2] = float("inf")
    rows[pick, col] = vals
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    out_k = scatter_accumulate(idx, rows, n_rows)
    out_p = scatter_accumulate_plain(idx, rows, n_rows)
    perm = torch.randperm(M, generator=gen).to(device)
    out_s = scatter_accumulate(idx[perm], rows[perm], n_rows)
    if not (torch.equal(bits(out_k), bits(out_p))
            and torch.equal(bits(out_k), bits(out_s))):
        raise AssertionError(f"K9 {tag} non-finite: not bitwise equal to "
                             "the plain version / across row orders")
    i64 = idx.long()
    count = lambda m: torch.zeros(n_rows, D, device=device).index_add_(  # noqa: E731
        0, i64, m.float())
    nan_in, pinf_in, ninf_in = (count(rows.isnan()) > 0,
                                count(rows == float("inf")) > 0,
                                count(rows == float("-inf")) > 0)
    want_nan = nan_in | (pinf_in & ninf_in)
    want_pinf = pinf_in & ~want_nan
    want_ninf = ninf_in & ~want_nan
    finite_ref = scatter_accumulate(
        idx, torch.where(torch.isfinite(rows), rows, 0.0), n_rows)
    hit = want_nan | want_pinf | want_ninf
    dest_hit = hit.any(1, keepdim=True).expand(-1, D)
    ok = (torch.equal(out_k.isnan(), want_nan)
          and torch.equal(out_k == float("inf"),
                          want_pinf | ((finite_ref == float("inf")) & ~hit))
          and torch.equal(out_k == float("-inf"),
                          want_ninf | ((finite_ref == float("-inf")) & ~hit))
          and torch.equal(bits(out_k[dest_hit & ~hit]),
                          bits(finite_ref[dest_hit & ~hit])))
    if not ok:
        raise AssertionError(f"K9 {tag} non-finite: per-column classes or "
                             "finite columns wrong")
    return {"shape": f"{tag} non-finite M={M} D={D} rows={n_rows}",
            "non_finite_terms": int(len(pick)),
            "nan_columns": int(want_nan.sum()),
            "inf_columns": int((want_pinf | want_ninf).sum()),
            "bitwise_vs_plain": True, "bitwise_shuffled": True,
            "max_abs_err": 0.0}


# K4 against another computation of the same function (its plain version,
# or the JAX package's `mlp_apply` and its VJP), per element: within one
# bf16 ulp of its magnitude plus K4_TERMS of its sum of |terms|; no more
# than K4_OFF_SHARE of an output's elements (or 2) off by more than K4_OFF
# of their sum of |terms|, the most that summing the same f32 terms in
# another order moves an element that no bf16 rounding took apart; and the
# weight gradients bf16 values.
K4_TERMS = 2.0 ** -8
K4_OFF = 2.0 ** -16
K4_OFF_SHARE = 0.01
# the rounding points of K4's function (`kernels/fused_mlp.py`): the input,
# the hidden layer, the hidden-layer gradient, the input gradient, the
# weight gradients
K4_ROUNDINGS = ("x", "h", "g_h", "g_x", "dW")
# the controls of the K4 check (`k4_control`): the plain version without
# each of its rounding points, with d rounded to bf16 as well (a rounding
# point it does not have: a bf16 mma on d would add it), each of which must
# fail; and with every product's sum taken in f64, which must pass
K4_CONTROLS = K4_ROUNDINGS + ("bf16_d", "f64")


def k4_terms(x, heads, g_out) -> list:
    """Each K4 output element's sum of |terms|, in the order of `k4_flat`
    (out, g_x, then dW0 and dW1 a head). `heads` are (w0, w1, activation).
    Two computations that sum the same terms in other orders, in f32, can
    land a bf16 rounding of a hidden unit, of a hidden or input gradient or
    of a weight gradient one bf16 step (at most 2^-7 of the value, 2^-8 of
    the terms it rounds) apart; the terms that carry such a step into an
    element are among the terms of its sum."""
    import torch
    from unislam_tpu_torch.kernels import fused_mlp as fm

    xb = fm._bf16(x)
    t_out, t_gx, t_w, col = [], 0.0, [], 0
    for w0, w1, act in heads:
        w0b, w1b = fm._bf16(w0), fm._bf16(w1)
        a = xb @ w0b
        h = fm._bf16(torch.relu(a))
        t = fm._activate(h @ w1b, act)
        g = g_out[:, col:col + w1.shape[1]]
        col += w1.shape[1]
        d = (g * (1.0 - t) * (1.0 + t) if act == "tanh" else
             g * t * (1.0 - t) if act == "sigmoid" else g)
        z = fm._bf16(d @ w1b.t()).abs() * (a >= 0)
        t_out.append(h @ w1b.abs())
        t_gx = t_gx + z @ w0b.abs().t()
        t_w += [xb.abs().t() @ z, h.t() @ d.abs()]
    return [torch.cat(t_out, dim=-1), t_gx] + t_w


def k4_flat(out, g_x, dws) -> list:
    """(out, g_x, [(dW0, dW1) a head]) -> [out, g_x, dW0, dW1, ...]."""
    return [out, g_x] + [w for pair in dws for w in pair]


def k4_outputs(out, g_x, dws) -> list:
    """`k4_flat` of K4's forward and backward as the main path uses them:
    the weight gradients, f32 sums out of the kernel and its plain version,
    rounded to bf16 as `Mapper.backward` rounds them (`round_bf16_`)."""
    from unislam_tpu_torch.kernels import fused_mlp as fm

    return k4_flat(out, g_x, [(fm._bf16(a), fm._bf16(b)) for a, b in dws])


def k4_misfit(ours, ref, terms, rounded: bool = False) -> dict:
    """How far K4 output `ours` is from `ref` (see K4_TERMS): `ratio`, the
    largest error over its per-element bound; `off`, the elements off by
    more than K4_OFF of their terms; `ok` when every element is within its
    bound and finite where `ref` is, `off` is at most K4_OFF_SHARE of the
    elements or 2, and, where `rounded` (a weight gradient), every element
    of `ours` is a bf16 value."""
    import torch
    from unislam_tpu_torch.kernels import fused_mlp as fm

    err = (ours - ref).abs()
    _, e = torch.frexp(ref.abs())
    ulp = torch.where(ref == 0, 0.0, torch.ldexp(torch.ones_like(ref),
                                                 e - 8))
    bound = ulp + K4_TERMS * terms
    ratio = float(torch.where(err == 0, 0.0, err / bound).max())
    off = int((err > K4_OFF * terms).sum())
    ok = (bool(torch.isfinite(ours).eq(torch.isfinite(ref)).all())
          and ratio <= 1.0 and off <= max(K4_OFF_SHARE * ours.numel(), 2)
          and not (rounded and not torch.equal(ours, fm._bf16(ours))))
    return {"ok": ok, "ratio": ratio, "off": off, "n": ours.numel()}


def k4_fits(ours: list, ref: list, terms: list) -> list:
    """`k4_misfit` of each output of `k4_flat`'s lists (the weight
    gradients, from the third on, `rounded`)."""
    return [k4_misfit(o, r, t, rounded=i >= 2)
            for i, (o, r, t) in enumerate(zip(ours, ref, terms))]


def k4_planted(x, heads, g_out, skip=None, f64=False,
               round_d=False) -> list:
    """K4's function as `kernels/fused_mlp.py`'s plain version computes it,
    but without one of its rounding points (`skip`, one of K4_ROUNDINGS),
    or with d rounded to bf16 before d @ bf16(W1)^T and h^T d (`round_d`),
    or (`f64`) with every product's sum taken in f64 and then rounded.
    Returns `k4_flat`'s list."""
    import torch
    from unislam_tpu_torch.kernels import fused_mlp as fm

    def rnd(name, t):
        return t if name == skip else fm._bf16(t)

    def mm(a, b):
        return (a.double() @ b.double()).float() if f64 else a @ b

    xb = rnd("x", x)
    outs, g_x, dws, col = [], None, [], 0
    for w0, w1, act in heads:
        w0b, w1b = fm._bf16(w0), fm._bf16(w1)
        a = mm(xb, w0b)
        h = rnd("h", torch.relu(a))
        t = fm._activate(mm(h, w1b), act)
        outs.append(t)
        g = g_out[:, col:col + w1.shape[1]]
        col += w1.shape[1]
        if act == "tanh":
            w = g * (1.0 - t)
            d = w + w * t
        else:
            d = g * (t * (1.0 - t)) if act == "sigmoid" else g
        if round_d:
            d = fm._bf16(d)
        mask = torch.where(a > 0, 1.0, torch.where(a == 0, 0.5, 0.0))
        z = rnd("g_h", mm(d, w1b.t())) * mask
        gx = rnd("g_x", mm(z, w0b.t()))
        g_x = gx if g_x is None else g_x + gx
        dws.append((rnd("dW", mm(xb.t(), z)), rnd("dW", mm(h.t(), d))))
    return k4_flat(torch.cat(outs, dim=-1), g_x, dws)


def k4_control(x, heads, g_out, control: str) -> list:
    """`k4_planted` for one of K4_CONTROLS."""
    if control == "f64":
        return k4_planted(x, heads, g_out, f64=True)
    if control == "bf16_d":
        return k4_planted(x, heads, g_out, round_d=True)
    return k4_planted(x, heads, g_out, skip=control)


def check_kernels(cfg, ds, device, n_map: int, n_track: int):
    """Returns {kernel: [per-shape record, ...]}; raises on disagreement.
    K1 and K2 also take each grid's `adversarial_points` (untimed, K2 with
    table rows), where the point gradient must be exactly 0 at every
    coordinate outside [0, 1].

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
        adv, outside = adversarial_tensor("hash", spec.scales, device)
        for phase, pts in (*pts_by_phase.items(), ("adversarial", adv)):
            N = pts.shape[0]
            tag = f"{grid}/{phase} N={N}"
            timed_shape = phase != "adversarial"
            # --- K1
            out_k = he.encode_fwd(table, pts, spec)
            out_p = he.encode_fwd_plain(table, pts, spec)
            ref_abs = he.encode_fwd_plain(table.abs(), pts, spec)
            err = (out_k - out_p).abs()
            if not bool(torch.isfinite(out_k).all()) or \
                    bool((err > 16 * ULP * ref_abs).any()):
                raise AssertionError(f"K1 {tag}: max err {float(err.max())}")
            rec = {"shape": tag, "max_abs_err": float(err.max())}
            if timed_shape:
                rec.update(timing(
                    lambda: he.encode_fwd(table, pts, spec),
                    lambda: he.encode_fwd_plain(table, pts, spec), device,
                    N * 12 + T * 8 + N * L * 8, N * L * 8 * 4))
            results["hash_encode_fwd"].append(rec)
            # --- K2 (mapping and the adversarial points emit table rows;
            # tracking only the points)
            g_out = torch.randn(N, spec.out_dim, generator=gen).to(device)
            rows_wanted = phase != "track"
            gp_k, ri_k, rv_k = he.encode_bwd(table, pts, g_out, spec, True,
                                             rows_wanted)
            gp_p, ri_p, rv_p = he.encode_bwd_plain(table, pts, g_out, spec,
                                                   True, rows_wanted)
            err_gp = (gp_k - gp_p).abs()
            tol_gp = 1e-4 * gp_p.abs() + 1e-5 * float(gp_p.abs().max())
            errs = [float(err_gp.max())]
            bad = not bool(torch.isfinite(gp_k).all()) or \
                bool((err_gp > tol_gp).any())
            if not timed_shape:
                bad |= bool((gp_k[outside] != 0.0).any())
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
            rec = {"shape": tag + (" +rows" if rows_wanted else ""),
                   "max_abs_err": max(errs)}
            if timed_shape:
                rec.update(timing(
                    lambda: he.encode_bwd(table, pts, g_out, spec, True,
                                          rows_wanted),
                    lambda: he.encode_bwd_plain(table, pts, g_out, spec,
                                                True, rows_wanted), device,
                    N * 12 + N * L * 8 + T * 8 + N * 12
                    + rows_wanted * N * L * 8 * (4 + 8), N * L * 8 * 12,
                    plain_iters=5))
            results["hash_encode_bwd"].append(rec)
            if phase != "map":
                continue
            # --- K9 on the rows K2 emitted, and with non-finite terms
            results["scatter_accumulate"].append(check_scatter(
                ri_k, rv_k, T, f"{grid}/{phase}", device))
            results["scatter_accumulate"].append(check_scatter_non_finite(
                ri_k, rv_k, T, f"{grid}/{phase}", device))
            del rv_k, ri_k, rv_p, ri_p
    return results


def check_k5(table, pts, spec, levels, out_k, tag: str) -> float:
    """K5's output `out_k` against the plain version: finite, and within
    16 u * sum_v w_v |f_v| per output. Returns the max abs error."""
    import torch
    from unislam_tpu_torch.models import brick_encoding as be

    out_p = be.encode_fwd_plain(table, pts, spec, levels)
    ref_abs = be.encode_fwd_plain(table.abs(), pts, spec, levels)
    err = (out_k - out_p).abs()
    if not bool(torch.isfinite(out_k).all()) or \
            bool((err > 16 * ULP * ref_abs).any()):
        raise AssertionError(f"K5 {tag}: max err {float(err.max())}")
    return float(err.max())


def check_brick_kernels(cfg, ds, device, n_map: int, n_track: int):
    """K5, K6 and K9 at the four encode groups of the brick drive (points
    from frame 0, the band as the renderer selects it), on a brick table
    from seed 1; K5 and K6 also at the ladder's `adversarial_points` over
    all levels (untimed, K6 with table rows), where the point gradient must
    be exactly 0 at every coordinate outside [0, 1]. K5 also alone at the
    no-depth probe's points (`probe_points`, the coarse levels of the
    mapping split; timed). K5 also grouped: the
    map pair, the track pair (timed beside the same groups launched one by
    one, `per_group_ms`) and the adversarial points as two groups split by
    level. Returns {kernel: [per-shape record, ...]}; raises on
    disagreement.

    Tolerances:
    - K5 forward: |kernel - plain| <= 16 u * sum_v w_v |f_v| per output
      (the same 8 rounded products, summed in possibly another order); a
      grouped launch bitwise equal to its groups launched one by one;
    - K6 backward: table-gradient destinations and values bitwise equal
      (both form bf16(bf16(w) * bf16(g)) from the same f32 weights); point
      gradient within 1e-4 relative plus 1e-5 of its largest magnitude
      (sums with cancellation, both f32), and bitwise equal on a repeat
      (a fixed summation tree);
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
    adv, outside = adversarial_tensor(
        "brick", spec.resolutions.astype("float32") - 1.0, device)
    groups.append(("adversarial", "all", adv, be.all_levels(spec)))
    map_idx, map_rows = [], []
    k5_cost = {}   # (phase, name) -> (bytes, flops) of K5 on that group
    for phase, name, pts, levels in groups:
        N, L = pts.shape[0], len(levels)
        tag = f"{phase}/{name} N={N} levels={list(levels)}"
        timed_shape = phase != "adversarial"
        vidx, _ = be._footprint(spec, pts, levels)
        touched = int(torch.unique(vidx).numel()) * F * 4
        k5_cost[phase, name] = (N * 12 + touched + N * L * F * 4,
                                N * L * (8 * 2 * F + 16))
        # --- K5, this group alone
        out_k = be.encode_fwd(table, pts, spec, levels)
        err = check_k5(table, pts, spec, levels, out_k, tag)
        rec = {"shape": tag, "max_abs_err": err}
        if timed_shape:
            rec.update(timing(
                lambda: be.encode_fwd(table, pts, spec, levels),
                lambda: be.encode_fwd_plain(table, pts, spec, levels),
                device, *k5_cost[phase, name]))
        results["brick_encode_fwd"].append(rec)
        # --- K6 (mapping and the adversarial points emit table rows;
        # tracking only the points)
        g_out = torch.randn(N, L * F, generator=gen).to(device)
        rows_wanted = phase != "track"
        gp_k, ri_k, rv_k = be.encode_bwd(table, pts, g_out, spec, levels,
                                         True, rows_wanted)
        gp_p, ri_p, rv_p = be.encode_bwd_plain(table, pts, g_out, spec,
                                               levels, True, rows_wanted)
        err_gp = (gp_k - gp_p).abs()
        tol_gp = 1e-4 * gp_p.abs() + 1e-5 * float(gp_p.abs().max())
        repeat = torch.equal(gp_k, be.encode_bwd(
            table, pts, g_out, spec, levels, True, rows_wanted)[0])
        bad = not bool(torch.isfinite(gp_k).all()) or not repeat or \
            bool((err_gp > tol_gp).any())
        if not timed_shape:
            bad |= bool((gp_k[outside] != 0.0).any())
        rows_equal = None
        if rows_wanted:
            rows_equal = torch.equal(ri_k, ri_p) and torch.equal(rv_k, rv_p)
            bad |= not rows_equal
        if phase == "map":
            map_idx.append(ri_k)
            map_rows.append(rv_k)
        if bad:
            raise AssertionError(f"K6 {tag}: point gradient max err "
                                 f"{float(err_gp.max())}, bitwise on a "
                                 f"repeat: {repeat}, rows bitwise equal: "
                                 f"{rows_equal}")
        rec = {"shape": tag + (" +rows" if rows_wanted else ""),
               "max_abs_err": float(err_gp.max()),
               "points_bitwise_repeat": repeat}
        if timed_shape:
            rec.update(timing(
                lambda: be.encode_bwd(table, pts, g_out, spec, levels, True,
                                      rows_wanted),
                lambda: be.encode_bwd_plain(table, pts, g_out, spec, levels,
                                            True, rows_wanted), device,
                N * 12 + N * L * F * 4 + touched + N * 12
                + rows_wanted * N * L * 8 * (4 + F * 4),
                N * L * (8 * 3 * F + 72), plain_iters=5))
        results["brick_encode_bwd"].append(rec)
        del rv_p, ri_p
    # --- K5 at the no-depth probe's shape: the mapping rays' uniform
    # samples, the coarse levels of the mapping split only (no K6: the
    # probe runs without gradients)
    pts = probe_points(cfg, ds, n_map, device, 13)
    levels = be.coarse_fine_split(spec, cfg["rendering"]["lod_split"])[0]
    N, L = pts.shape[0], len(levels)
    tag = f"probe/coarse N={N} levels={list(levels)}"
    vidx, _ = be._footprint(spec, pts, levels)
    touched = int(torch.unique(vidx).numel()) * F * 4
    out_k = be.encode_fwd(table, pts, spec, levels)
    rec = {"shape": tag,
           "max_abs_err": check_k5(table, pts, spec, levels, out_k, tag)}
    rec.update(timing(
        lambda: be.encode_fwd(table, pts, spec, levels),
        lambda: be.encode_fwd_plain(table, pts, spec, levels), device,
        N * 12 + touched + N * L * F * 4, N * L * (8 * 2 * F + 16)))
    results["brick_encode_fwd"].append(rec)
    # --- K5 grouped, as encode_multi launches it: the drive's two pairs
    # (timed; bound: the sum of the groups' bytes) and the adversarial
    # points split into two groups by level
    by_name = {(ph, nm): (pts, lv) for ph, nm, pts, lv in groups}
    adv_levels = be.all_levels(spec)
    pairs = [(ph, [by_name[ph, "coarse"], by_name[ph, "band"]],
              [k5_cost[ph, "coarse"], k5_cost[ph, "band"]])
             for ph in ("map", "track")]
    pairs.append(("adversarial", [(adv, adv_levels[:1]),
                                  (adv, adv_levels[1:])], None))
    for phase, members, costs in pairs:
        pts_t = tuple(p for p, _ in members)
        lv_t = tuple(lv for _, lv in members)
        tag = f"grouped {phase} " + " + ".join(
            f"N={p.shape[0]} levels={list(lv)}" for p, lv in members)
        outs = be.encode_fwd_multi(table, pts_t, spec, lv_t)
        for out_k, (p, lv) in zip(outs, members):
            if not torch.equal(out_k, be.encode_fwd(table, p, spec, lv)):
                raise AssertionError(f"K5 {tag}: not bitwise equal to the "
                                     "group-by-group launches")
        err = max(check_k5(table, p, spec, lv, out_k, tag)
                  for out_k, (p, lv) in zip(outs, members))
        rec = {"shape": tag, "max_abs_err": err,
               "bitwise_vs_per_group": True}
        if costs is not None:
            rec.update(timing(
                lambda: be.encode_fwd_multi(table, pts_t, spec, lv_t),
                lambda: be.encode_fwd_multi_plain(table, pts_t, spec, lv_t),
                device, sum(c[0] for c in costs), sum(c[1] for c in costs)))
            rec["per_group_ms"] = timed(lambda: [
                be.encode_fwd(table, p, spec, lv) for p, lv in members],
                device)
        results["brick_encode_fwd"].append(rec)
    # --- K9 on the mapping backward's rows, one call for both groups
    map_idx, map_rows = torch.cat(map_idx), torch.cat(map_rows)
    results["scatter_accumulate"].append(check_scatter(
        map_idx, map_rows, spec.total_rows * 27, "brick/map", device))
    results["scatter_accumulate"].append(check_scatter_non_finite(
        map_idx, map_rows, spec.total_rows * 27, "brick/map", device))
    return results


def k8_equal(a, b) -> bool:
    """K8 outputs (destinations, rows) equal: destinations bitwise, row
    values with == (so -0 and +0 are equal) and NaN matching NaN."""
    import torch
    (ia, ra), (ib, rb) = a, b
    return (torch.equal(ia, ib) and torch.equal(ra.isnan(), rb.isnan())
            and bool(((ra == rb) | ra.isnan()).all()))


def k8_hand_rays(K: int, F: int, seed: int):
    """Hand-made rays of K >= 8 samples at one level, as K6 emits their
    rows (a random in-brick cell a sample, bf16 values): one brick for all
    K; K distinct bricks (they overflow Ku < K); A A A B B A A A (three
    runs, not two); bricks 5 5 9 9 ... with an inf at sample 0 (its slot
    NaN in every later run and unused slot); a NaN in a one-brick ray; a
    -inf, and an inf then a -inf in one slot of one run. Returns
    (row_idx, rows, R) on the CPU."""
    import torch
    g = torch.Generator().manual_seed(seed)
    half = K // 2
    bricks = torch.tensor([[7] * K, list(range(10, 10 + K)),
                           [1] * 3 + [2] * 2 + [1] * (K - 5),
                           [5, 5] + [9] * (K - 2), [3] * K,
                           [4] * half + [6] * (K - half)])
    R = bricks.shape[0]
    local = torch.randint(0, 2, (R, K, 1, 3), generator=g)
    local[5, half + 2] = local[5, half + 1]     # one vertex slot, two samples
    corners = torch.tensor([[a, b, c] for a in (0, 1) for b in (0, 1)
                            for c in (0, 1)])
    vert = local + corners
    v = vert[..., 0] * 9 + vert[..., 1] * 3 + vert[..., 2]
    row_idx = (bricks[..., None] * 27 + v).to(torch.int32).reshape(-1)
    rows = torch.randn(R, K, 8, F, generator=g).bfloat16().float()
    rows[3, 0, 0, 2] = math.inf
    rows[4, 2, 3, 1] = math.nan
    rows[5, 1, 5, 0] = -math.inf
    rows[5, half + 1, 0, 4] = math.inf
    rows[5, half + 2, 0, 4] = -math.inf
    return row_idx, rows.reshape(-1, F), R


def k8_overflow(row_idx, rows, L: int, R: int, K: int, Ku: int) -> dict:
    """Per level, the share of rays whose band crosses more than Ku bricks
    and the mean run count; the share of the band's |gradient| (sum of
    |row values|) in runs past Ku, which the dedup drops."""
    import torch
    brick = row_idx.view(L, R, K, 8)[..., 0] // 27
    new = torch.ones_like(brick, dtype=torch.bool)
    new[..., 1:] = brick[..., 1:] != brick[..., :-1]
    rank = new.long().cumsum(-1) - 1
    mass = rows.view(L, R, K, -1).abs().sum(-1)
    return {"overflow_ray_share": [float(x) for x in
                                   (rank[..., -1] >= Ku).float().mean(1)],
            "mean_runs": [float(x) for x in
                          (rank[..., -1] + 1).float().mean(1)],
            "dropped_mass_share": float((mass * (rank >= Ku)).sum()
                                        / mass.sum())}


def check_k8(cfg, ds, device, n_map: int) -> dict:
    """K8, the band row dedup, against its plain version at Ku = 4
    (dedup_band 0.5) and Ku = 8 (1.0, no run dropped), on:
    - the band group's K6 rows of a mapping iteration of the brick drive
      (frame 0's rays, the band in z order, a brick table from seed 1 and
      a random cotangent), also with NaN and +-inf terms put in;
    - the hand-made rays of `k8_hand_rays`.
    Tolerance: `k8_equal` (bitwise but for the sign of zero), and bitwise
    on a second launch. Times K8, its plain version and its bound (bytes:
    each input row, an int32 and F f32, read once, and each output row
    written once); K9 on the mapping backward's rows (the coarse set's and
    the deduped band's, one call, through `check_scatter`) and beside it
    K9 on the same rows without the dedup. No PyTorch call computes this
    function, so `library_ms` is None. Returns {kernel: [records]}."""
    import torch
    from unislam_tpu_torch.kernels import band_dedup as bd
    from unislam_tpu_torch.kernels.scatter_accum import scatter_accumulate
    from unislam_tpu_torch.models import brick_encoding as be

    K = cfg["rendering"]["n_fine"]
    pts, sc, band = main_path_points(cfg, ds, n_map, device, 11, K,
                                     zsorted=True)
    spec = sc.brick_spec
    F = spec.n_features
    coarse, fine = be.coarse_fine_split(spec, cfg["rendering"]["lod_split"])
    gen = torch.Generator().manual_seed(1)
    table = be.init_table(spec, gen, device)
    g_c = torch.randn(pts.shape[0], len(coarse) * F, generator=gen)
    g_b = torch.randn(band.shape[0], len(fine) * F, generator=gen)
    _, ri_c, rv_c = be.encode_bwd(table, pts, g_c.to(device), spec, coarse,
                                  False, True)
    _, ri_b, rv_b = be.encode_bwd(table, band, g_b.to(device), spec, fine,
                                  False, True)
    L, R = len(fine), n_map
    rv_nf = rv_b.clone()
    n = rv_nf.shape[0] // 10_000
    pick = torch.randperm(rv_nf.shape[0], generator=gen)[:3 * n].to(device)
    col = torch.randint(0, F, (3 * n,), generator=gen).to(device)
    rv_nf[pick, col] = torch.tensor([math.nan, math.inf, -math.inf],
                                    device=device).repeat_interleave(n)
    h_idx, h_rows, h_R = k8_hand_rays(K, F, 4)
    cases = [("map", ri_b, rv_b, L, R), ("map non-finite", ri_b, rv_nf, L, R),
             ("hand", h_idx.to(device), h_rows.to(device), 1, h_R)]
    T = spec.total_rows * 27
    results = {"band_dedup": [], "scatter_accumulate": []}
    for Ku in (4, 8):
        for name, ri, rv, lv, r in cases:
            tag = f"{name} Ku={Ku} L={lv} R={r} K={K} F={F}"
            out_k = bd.dedup_rows(ri, rv, r, K, Ku)
            out_p = bd.dedup_rows_plain(ri, rv, r, K, Ku)
            again = bd.dedup_rows(ri, rv, r, K, Ku)
            repeat = torch.equal(out_k[0], again[0]) and torch.equal(
                out_k[1].view(torch.int32), again[1].view(torch.int32))
            if not (k8_equal(out_k, out_p) and repeat):
                raise AssertionError(f"K8 {tag}: differs from the plain "
                                     f"version or on a repeat ({repeat})")
            fin = torch.isfinite(out_p[1])
            rec = {"shape": tag, "bitwise_vs_plain": True,
                   "bitwise_repeat": True,
                   "max_abs_err": float((out_k[1] - out_p[1])[fin].abs()
                                        .max()),
                   "nan_values": int(out_k[1].isnan().sum()),
                   "rows_in": ri.numel(), "rows_out": out_k[0].numel()}
            if name == "map":
                nb = (ri.numel() + out_k[0].numel()) * (4 + 4 * F)
                rec.update(timing(
                    lambda: bd.dedup_rows(ri, rv, r, K, Ku),
                    lambda: bd.dedup_rows_plain(ri, rv, r, K, Ku), device,
                    nb, (ri.numel() + out_k[0].numel()) * F, plain_iters=5))
                rec.update(k8_overflow(ri, rv, lv, r, K, Ku))
                k9 = check_scatter(torch.cat([ri_c, out_k[0]]),
                                   torch.cat([rv_c, out_k[1]]), T,
                                   f"dedup brick/map Ku={Ku}", device)
                results["scatter_accumulate"].append(k9)
                rows_u = torch.cat([rv_c, rv_b])
                idx_u = torch.cat([ri_c, ri_b])
                rec["k9_deduped_ms"] = k9["ms"]
                rec["k9_undeduped_ms"] = timed(
                    lambda: scatter_accumulate(idx_u, rows_u, T), device)
                del rows_u, idx_u
            results["band_dedup"].append(rec)
            del out_k, out_p, again
    return results


# K3's adversarial rays: kind -> (rays, samples, beta); the first quarter of
# the rays carries the adversarial sdf (`k3_rays`)
K3_ADVERSARIAL = {"saturated": (16, 32, 20.0),
                  "zero_weights": (16, 40, 10.0),
                  "nan": (16, 40, 10.0)}


def k3_rays(kind: str, R: int, S: int, beta: float, seed: int):
    """numpy raw (R, S, 4) [uniform rgb, sdf ~ N(0, 0.5)], z (R, S)
    sorted in [0.1, 4) and beta, float32. The first quarter of the rays (at
    least one) carries `kind`'s sdf: "saturated" -1 at every sample (at
    beta = 20, alpha = 1.0 in f32: factors of 1e-10, T below the denormals
    within 5 samples), "zero_weights" +50 (every weight 0, so std = 0),
    "nan" a NaN at sample 5 of ray 0; any other kind, none."""
    import numpy as np

    rng = np.random.default_rng(seed)
    raw = np.concatenate([rng.uniform(size=(R, S, 3)),
                          rng.normal(scale=0.5, size=(R, S, 1))], axis=-1)
    z = np.sort(rng.uniform(0.1, 4.0, size=(R, S)), axis=1)
    n_adv = max(R // 4, 1)
    if kind == "saturated":
        raw[:n_adv, :, 3] = -1.0
    elif kind == "zero_weights":
        raw[:n_adv, :, 3] = 50.0
    elif kind == "nan":
        raw[0, 5, 3] = np.nan
    return raw.astype(np.float32), z.astype(np.float32), np.float32(beta)


def k3_inputs(cfg, ds, n_rays: int, device, seed: int, mode: str):
    """raw (R, S, 4), z (R, S) and beta (1,) as a render of `n_rays` rays
    of frame 0 hands K3: z as the renderer draws it ("render": depth-guided
    32 + 8 with jitter; "chunk": the same without, as `render_img`;
    "probe": 32 uniform to the scene's bound); sdf the distance to the
    sensor's surface along the ray (depth - z) plus 1 cm of noise; colours
    uniform; beta the config's initial 10."""
    import torch
    from unislam_tpu_torch.core import rays as rays_lib
    from unislam_tpu_torch.core import rng, sampling
    from unislam_tpu_torch.models import scene as scene_lib

    sc = scene_lib.make_scene_config(cfg)
    color, depth, c2w = ds[0]
    g = rng.generator(seed, device)
    intr = ds.intr
    i, j, gd, _ = rays_lib.sample_pixels(
        n_rays, 0, intr.H, 0, intr.W, torch.as_tensor(depth, device=device),
        torch.as_tensor(color, device=device), g)
    r = cfg["rendering"]
    if mode == "probe":
        o, d = rays_lib.rays_from_uv(i, j, torch.as_tensor(c2w, device=device),
                                     intr)
        far = rays_lib.ray_aabb_far(o, d, sc.bound_tensors(device)[0])
        z = sampling.z_vals_uniform(far, r["n_stratified"], True, g)
    else:
        z = sampling.z_vals_with_depth(gd, sc.truncation, r["n_stratified"],
                                       r["n_importance"], mode == "render", g)
    sdf = gd[:, None] - z + 0.01 * torch.randn(z.shape, generator=g,
                                               device=device)
    rgb = torch.rand(*z.shape, 3, generator=g, device=device)
    raw = torch.cat([rgb, sdf[..., None]], dim=-1).contiguous()
    beta = torch.full((1,), sc.beta_init, device=device)
    return raw, z.contiguous(), beta


def k3_value_terms(raw, z, beta):
    """Each forward output's sum of |terms| from the plain weights: rgb
    sum w|c|, depth sum w|z|, term sum w, unc (1 + term)^2, std
    sqrt(sum w (|D| + |z|)^2)."""
    import torch
    from unislam_tpu_torch.kernels import composite as k3

    with torch.no_grad():
        w = k3.exclusive_cumprod_weights(k3.sdf2alpha(raw[..., 3], beta))
        term = w.sum(-1)
        d = (w * z).sum(-1)
        return ((w[..., None] * raw[..., :3].abs()).sum(-2),
                (w * z.abs()).sum(-1), term, (1.0 + term) ** 2,
                torch.sqrt((w * (d.abs()[:, None] + z.abs()) ** 2).sum(-1)))


def k3_grad_terms(raw, z, beta, gs):
    """d_raw's (R, S, 4) and d beta's sums of |terms|: the backward of
    `kernels/composite.py` with every term and cotangent at its magnitude,
    so nothing cancels (`gs` the five cotangents, None where not passed):
    |g_w_k| = |g_rgb||c_k| + |g_D'||z_k| + |g_term'| + |g_std'|(D - z_k)^2,
    A_k = |g_w_{k+1}| alpha_{k+1} + f_{k+1} A_{k+1},
    d alpha_k = T_k (|g_w_k| + A_k), then |d alpha / d sdf|, |d alpha /
    d beta| term by term."""
    import torch

    with torch.no_grad():
        sdf = raw[..., 3]
        s = torch.sigmoid(-sdf * beta)
        e = torch.exp(-beta * s)
        a = 1.0 - e
        f = 1.0 - a + 1e-10
        T = torch.cumprod(torch.cat([torch.ones_like(f[:, :1]), f[:, :-1]],
                                    -1), -1)
        w = a * T
        D = (w * z).sum(-1)
        std = torch.sqrt((w * (D[:, None] - z) ** 2).sum(-1))
        zero = torch.zeros_like(D)
        g_rgb = raw.new_zeros(D.shape[0], 3) if gs[0] is None \
            else gs[0].abs()
        g_d, g_t, g_u, g_s = (zero if g is None else g.abs() for g in gs[1:])
        g_t = g_t + 2.0 * (1.0 - w.sum(-1)).abs() * g_u
        g_s = g_s / (2.0 * std) if gs[4] is not None else zero
        g_d = g_d + g_s * (w * 2.0 * (D[:, None] - z).abs()).sum(-1)
        gw = ((g_rgb[:, None, :] * raw[..., :3].abs()).sum(-1)
              + g_d[:, None] * z.abs() + g_t[:, None]
              + g_s[:, None] * (D[:, None] - z) ** 2)
        S = z.shape[1]
        acc = torch.zeros_like(D)
        da = [None] * S
        for k in range(S - 1, -1, -1):
            da[k] = T[:, k] * (gw[:, k] + acc)
            acc = gw[:, k] * a[:, k] + f[:, k] * acc
        da = torch.stack(da, -1)
        ds = s * (1.0 - s)
        d_raw = torch.cat([g_rgb[:, None, :] * w[..., None],
                           (da * e * beta * ds * beta)[..., None]], -1)
        d_beta = (da * e * (s + beta * ds * sdf.abs())).sum()
        return d_raw, d_beta


def k3_misfit(ours, ref, terms, grad: bool) -> dict:
    """K3 against its plain version: NaN where the plain version has NaN,
    the same inf where it has inf, and elsewhere |ours - ref| <= rtol *
    terms + atol: values rtol 1e-5, atol 1e-6; gradients rtol 1e-4, atol
    1e-5 of the largest finite |ref| (the CPU tests' tolerances, relative
    to each element's sum of |terms|). Returns the largest finite error
    and error / tolerance, and whether it holds."""
    import torch

    nan_ok = torch.equal(ours.isnan(), ref.isnan())
    inf = ref.isinf()
    inf_ok = torch.equal(ours.isinf(), inf) and torch.equal(ours[inf],
                                                            ref[inf])
    fin = torch.isfinite(ref)
    err = (ours - ref)[fin].abs().double()
    if grad:
        top = ref[fin].abs().max() if fin.any() else ref.new_zeros(())
        tol = 1e-4 * terms[fin].double() + 1e-5 * float(top)
    else:
        tol = 1e-5 * terms[fin].double() + 1e-6
    ratio = float((err / tol).max()) if err.numel() else 0.0
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "tol_ratio": ratio,
            "ok": bool(nan_ok and inf_ok and ratio <= 1.0)}


def check_k3(cfg, ds, device, n_track: int, n_map: int, chunk: int) -> dict:
    """K3, the compositing kernel, against its plain version
    (`kernels/composite.py`) at the main path's shapes and on adversarial
    rays:
    - forward (five outputs) at track (n_track x 40), map (n_map x 40) and
      a `render_img` chunk (chunk x 40), and probe mode (w and sum w z) at
      n_map x 32; inputs from `k3_inputs`;
    - backward (d raw, d beta) at track and map with the loop's cotangents
      (rgb and depth; the other three not passed) and with all five;
    - the adversarial rays of `K3_ADVERSARIAL` in every mode (saturated
      alpha, all-zero weights with and without g_std, NaN sdf), and R = 0
      (empty outputs, no launch).
    Tolerance: `k3_misfit` against `k3_value_terms` / `k3_grad_terms`;
    every output bitwise equal on a second launch. Times the kernel, the
    plain version and the bound: bytes (raw and z read once, 20 bytes a
    sample, 8 in probe mode; outputs written once: 28 bytes a ray forward;
    w and D in probe mode; d raw 16 bytes a sample and the saved D, term,
    std and the passed cotangents read, backward) or operations (about 40
    f32 operations a sample forward, 60 backward, 12 in probe mode),
    whichever is larger. No one PyTorch call composites, so `library_ms`
    is None. Returns {kernel: [records]}."""
    import numpy as np
    import torch
    from unislam_tpu_torch.kernels import build
    from unislam_tpu_torch.kernels import composite as k3

    def bitwise(a, b):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(a, b))

    results = {"composite_fwd": [], "composite_bwd": []}
    cases = [("track", n_track, "render", 21), ("map", n_map, "render", 22),
             ("render chunk", chunk, "chunk", 23),
             ("probe", n_map, "probe", 24)]
    inputs = {name: k3_inputs(cfg, ds, n, device, seed, mode)
              for name, n, mode, seed in cases}
    for kind, (R, S, b) in K3_ADVERSARIAL.items():
        raw, z, beta = k3_rays(kind, R, S, b, 30)
        inputs[f"adversarial {kind}"] = tuple(
            torch.as_tensor(x, device=device)
            for x in (raw, z, np.array([beta])))
    for name, (raw, z, beta) in inputs.items():
        R, S = z.shape
        tag = f"{name} R={R} S={S}"
        if name == "probe" or name.startswith("adversarial"):
            sdf = raw[..., 3].contiguous()
            got = k3.probe_weights(sdf, z, beta)
            ref = k3.probe_weights_plain(sdf, z, beta)
            fits = [k3_misfit(got[0], ref[0], ref[0].abs(), False),
                    k3_misfit(got[1], ref[1], (ref[0] * z.abs()).sum(-1),
                              False)]
            if not (all(f["ok"] for f in fits)
                    and bitwise(got, k3.probe_weights(sdf, z, beta))):
                raise AssertionError(f"K3 probe {tag}: {fits}")
            rec = {"shape": f"probe mode {tag}" if name != "probe" else tag,
                   "bitwise_repeat": True,
                   "max_abs_err": max(f["max_abs_err"] for f in fits),
                   "tol_ratio": max(f["tol_ratio"] for f in fits)}
            if name == "probe":
                rec.update(timing(
                    lambda: k3.probe_weights(sdf, z, beta),
                    lambda: k3.probe_weights_plain(sdf, z, beta), device,
                    R * S * 12 + R * 4 + 4, R * S * 12))
            results["composite_fwd"].append(rec)
            if name == "probe":
                continue
        # forward
        with torch.no_grad():
            got = k3.composite(raw, z, beta)
            ref = k3.composite_plain(raw, z, beta)
            again = k3.composite(raw, z, beta)
        fits = [k3_misfit(a, b, t, False) for a, b, t in
                zip(got, ref, k3_value_terms(raw, z, beta))]
        if not (all(f["ok"] for f in fits) and bitwise(got, again)):
            raise AssertionError(f"K3 forward {tag}: {fits}")
        rec = {"shape": tag, "bitwise_repeat": True,
               "max_abs_err": max(f["max_abs_err"] for f in fits),
               "tol_ratio": max(f["tol_ratio"] for f in fits)}
        if not name.startswith("adversarial"):
            rec.update(timing(
                lambda: k3.composite(raw, z, beta),
                lambda: k3.composite_plain(raw, z, beta), device,
                R * S * 20 + R * 28 + 4, R * S * 40))
        results["composite_fwd"].append(rec)
        if name == "render chunk":
            continue
        # backward: the loop's cotangents, then all five
        gen = torch.Generator(device=device).manual_seed(R)
        g_all = [torch.randn(R, 3, generator=gen, device=device)] + [
            torch.randn(R, generator=gen, device=device) for _ in range(4)]
        for cot, keep in (("loop", (0, 1)), ("all", (0, 1, 2, 3, 4))):
            gs = [g_all[i] if i in keep else None for i in range(5)]
            leaves = (raw.clone().requires_grad_(True),
                      beta.clone().requires_grad_(True))
            out_k = k3.composite(leaves[0], z, leaves[1])
            out_p = k3.composite_plain(leaves[0], z, leaves[1])

            def grads(outs):
                return torch.autograd.grad(
                    [outs[i] for i in keep], leaves, [g_all[i] for i in keep],
                    retain_graph=True)

            before = build.LAUNCHES["composite_bwd"]
            got, again, ref = grads(out_k), grads(out_k), grads(out_p)
            if build.LAUNCHES["composite_bwd"] != before + 2:
                raise AssertionError(f"K3 backward {tag}: not one launch")
            terms = k3_grad_terms(raw, z, beta.reshape(()), gs)
            fits = [k3_misfit(got[0], ref[0], terms[0], True),
                    k3_misfit(got[1].reshape(()), ref[1].reshape(()),
                              terms[1], True)]
            if not (all(f["ok"] for f in fits) and bitwise(got, again)):
                raise AssertionError(f"K3 backward {cot} {tag}: {fits}")
            rec = {"shape": f"{name} {cot} R={R} S={S}",
                   "bitwise_repeat": True,
                   "max_abs_err": max(f["max_abs_err"] for f in fits),
                   "tol_ratio": max(f["tol_ratio"] for f in fits),
                   "d_raw_finite": bool(torch.isfinite(got[0]).all())}
            # finite but for the NaN rays, and the all-zero-weight rays
            # when g_std is passed (JAX's NaN class at std = 0)
            needs_finite = name != "adversarial nan" and (
                name != "adversarial zero_weights" or cot == "loop")
            if needs_finite and not rec["d_raw_finite"]:
                raise AssertionError(f"K3 backward {cot} {tag}: d raw not "
                                     "finite")
            if not name.startswith("adversarial"):
                # per ray: D and the cotangents (rgb, depth), and with all
                # five also term, std and theirs
                per_ray = 4 * (5 if cot == "loop" else 10)
                rec.update(timing(
                    lambda: grads(out_k), lambda: grads(out_p), device,
                    R * S * 36 + R * per_ray + 8, R * S * 60))
            results["composite_bwd"].append(rec)
            del out_k, out_p, leaves
    # no rays: empty outputs, no launch
    before = dict(build.LAUNCHES)
    raw, z, beta = inputs["map"]
    outs = k3.composite(raw[:0], z[:0], beta)
    w, d = k3.probe_weights(raw[:0, :, 3], z[:0], beta)
    if [o.numel() for o in (*outs, w, d)] != [0] * 7 \
            or dict(build.LAUNCHES) != before:
        raise AssertionError("K3: R = 0 launched or gave outputs")
    return results


def grid_batch(cfg, device, n: int):
    """`n` points of the mesher's 1 cm grid over the config's
    marching_cubes_bound, from the middle of the grid (one SDF batch of
    `Mesher.eval_points`), normalised: (n, 3)."""
    from unislam_tpu_torch.models import scene as scene_lib
    from unislam_tpu_torch.utils.mesher import GridPoints, Mesher

    sc = scene_lib.make_scene_config(cfg)
    grid = GridPoints(Mesher(cfg, sc, None).grid_axes(), device)
    mid = len(grid) // 2
    return scene_lib.normalize_points(sc, grid[mid:mid + n]).contiguous()


def check_inference_kernels(setups, device, mesh_batch: int,
                            render_rays: int) -> dict:
    """K1 and K5 at the shapes of meshing and `render_img`, under
    `torch.no_grad()` as those call them, against their plain versions
    (the tolerances of `check_kernels` / `check_k5`), timed, with their
    byte bounds:
    - K1: the SDF grid of a 500,000-point mesh batch; the SDF and colour
      grids at one render chunk (`render_rays` rays x 40 samples);
    - K5: a mesh batch at the coarse levels (LOD pass 1) and at the full
      ladder (pass 2, vertex colours); one render chunk's groups (the
      coarse levels at every sample, the fine levels at the 8 band
      samples) in one grouped launch."""
    import torch
    from unislam_tpu_torch.models import brick_encoding as be
    from unislam_tpu_torch.models import hash_encoding as he

    results = {"hash_encode_fwd": [], "brick_encode_fwd": []}
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        cfg, ds = setups["hash"]
        pts_mesh = grid_batch(cfg, device, mesh_batch)
        pts_render, sc, _ = main_path_points(cfg, ds, render_rays, device,
                                             13, perturb=False)
        for grid, spec, phase, pts in (
                ("sdf", sc.sdf_spec, "mesh", pts_mesh),
                ("sdf", sc.sdf_spec, "render", pts_render),
                ("color", sc.color_spec, "render", pts_render)):
            table = he.init_table(spec, gen, device)
            N, T, L = pts.shape[0], spec.total_entries, spec.n_levels
            out_k = he.encode_fwd(table, pts, spec)
            out_p = he.encode_fwd_plain(table, pts, spec)
            err = (out_k - out_p).abs()
            if not bool(torch.isfinite(out_k).all()) or bool(
                    (err > 16 * ULP * he.encode_fwd_plain(
                        table.abs(), pts, spec)).any()):
                raise AssertionError(f"K1 {grid}/{phase}: max err "
                                     f"{float(err.max())}")
            rec = {"shape": f"{grid}/{phase} N={N}",
                   "max_abs_err": float(err.max())}
            rec.update(timing(lambda: he.encode_fwd(table, pts, spec),
                              lambda: he.encode_fwd_plain(table, pts, spec),
                              device, N * 12 + T * 8 + N * L * 8,
                              N * L * 8 * 4, plain_iters=5))
            results["hash_encode_fwd"].append(rec)
            del table

        cfg, ds = setups["brick"]
        n_fine = cfg["rendering"]["n_fine"]
        pts_mesh = grid_batch(cfg, device, mesh_batch)
        pts_render, sc, band = main_path_points(
            cfg, ds, render_rays, device, 13, n_fine, perturb=False)
        spec = sc.brick_spec
        table = be.init_table(spec, gen, device)
        coarse, fine = be.coarse_fine_split(spec,
                                            cfg["rendering"]["lod_split"])
        F = spec.n_features

        def cost(pts, levels):
            vidx, _ = be._footprint(spec, pts, levels)
            N, L = pts.shape[0], len(levels)
            return (N * 12 + int(torch.unique(vidx).numel()) * F * 4
                    + N * L * F * 4, N * L * (8 * 2 * F + 16))

        for tag, pts, levels in (("mesh/coarse", pts_mesh, coarse),
                                 ("mesh/all", pts_mesh, be.all_levels(spec))):
            out_k = be.encode_fwd(table, pts, spec, levels)
            err = check_k5(table, pts, spec, levels, out_k, tag)
            rec = {"shape": f"{tag} N={pts.shape[0]} levels={list(levels)}",
                   "max_abs_err": err}
            rec.update(timing(
                lambda: be.encode_fwd(table, pts, spec, levels),
                lambda: be.encode_fwd_plain(table, pts, spec, levels),
                device, *cost(pts, levels), plain_iters=5))
            results["brick_encode_fwd"].append(rec)
        pts_t, lv_t = (pts_render, band), (coarse, fine)
        outs = be.encode_fwd_multi(table, pts_t, spec, lv_t)
        err = max(check_k5(table, p, spec, lv, o, "render")
                  for o, p, lv in zip(outs, pts_t, lv_t))
        costs = [cost(p, lv) for p, lv in zip(pts_t, lv_t)]
        rec = {"shape": "grouped render " + " + ".join(
            f"N={p.shape[0]} levels={list(lv)}" for p, lv in zip(pts_t, lv_t)),
               "max_abs_err": err}
        rec.update(timing(
            lambda: be.encode_fwd_multi(table, pts_t, spec, lv_t),
            lambda: be.encode_fwd_multi_plain(table, pts_t, spec, lv_t),
            device, sum(c[0] for c in costs), sum(c[1] for c in costs),
            plain_iters=5))
        results["brick_encode_fwd"].append(rec)
    return results


def k4_features(n: int, in_dim: int, seed: int, adversarial: bool = False):
    """(n, in_dim) decoder input features at the scale of trained tables,
    from `seed`. `adversarial`: rows of exact zeros (every pre-activation
    0, where ReLU's derivative is JAX's 0.5), of values on bf16 rounding
    ties, and of +-3000 (tanh and sigmoid saturate), a third each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.5, size=(n, in_dim)).astype(np.float32)
    if adversarial:
        k = n // 3
        x[:k] = 0.0
        ties = 1.0 + (2 * rng.integers(0, 64, (k, in_dim)) + 1) / 256.0
        x[k:2 * k] = ties * rng.choice([-1.0, 1.0], (k, in_dim))
        x[2 * k:] = rng.choice([-3e3, 3e3], (n - 2 * k, in_dim))
    return x


def check_k4(device) -> dict:
    """The fused decoder (K4) at the decoder's main-path shapes: brick
    features (in 24) at a mapping iteration (168,000 points), a tracking
    iteration (80,000) and a render chunk (10,000 rays x 40 = 400,000), both
    heads in one launch; hash features (in 32) at a mapping iteration and a
    500,000-point mesh batch, the SDF head alone (each hash head has its
    own features); and 3,000 adversarial points (`k4_features`) for both
    widths and for one head of width 13 without an activation, untimed.
    Weights from the JAX package's init bound, inputs from numpy seeds.

    For each: the forward, the backward with weight gradients and the
    backward without them, against the plain version within `k4_misfit`;
    the backward's outputs bitwise equal on a second run (no float
    atomics), and its input gradient bitwise equal with and without the
    weight gradients. Controls at the timed shapes (`k4_control`): the
    plain version without each one of its rounding points, or with d
    rounded to bf16 too, must fail `k4_misfit` against the plain version,
    and with its products summed in f64 must pass. Timed: kernel, plain
    version, and as a reference point `library_ms`, the same products as
    bf16 `torch.matmul` calls (the
    forward's two a head; the backward's five a head with the weight
    gradients, two without), which round at other points and are not this
    function; and beside the backward without weight gradients `copy_ms`,
    one PyTorch copy of x into an f32 tensor of g_x's shape. Bound: the
    bytes the call
    moves (x, g_out, outputs, weights) against HBM; the products at the
    bf16 tensor-core rate."""
    import torch
    from unislam_tpu_torch.kernels import fused_mlp as fm

    gen = torch.Generator().manual_seed(7)

    def head(in_dim, out_dim):
        b0, b1 = 1.0 / in_dim ** 0.5, 0.25
        return ((torch.rand(in_dim, 16, generator=gen) * 2 - 1) * b0).to(
            device), ((torch.rand(16, out_dim, generator=gen) * 2 - 1)
                      * b1).to(device)

    results = {"fused_mlp_fwd": [], "fused_mlp_bwd": []}
    brick = [(*head(24, 3), "sigmoid"), (*head(24, 1), "tanh")]
    hash_sdf = [(*head(32, 1), "tanh")]
    # an input width that is not a multiple of 4, which K4 moves a row at a
    # time, not in 16-byte chunks; and the "none" activation (own draws)
    gen_odd = torch.Generator().manual_seed(8)
    odd = [((torch.rand(13, 16, generator=gen_odd) * 2 - 1) / 13 ** 0.5).to(
        device), ((torch.rand(16, 2, generator=gen_odd) * 2 - 1) * 0.25).to(
        device), "none"]
    cases = [("brick/map", brick, 168_000), ("brick/track", brick, 80_000),
             ("brick/render", brick, 400_000), ("hash/map sdf", hash_sdf,
                                                 168_000),
             ("hash/mesh sdf", hash_sdf, 500_000),
             ("brick/adversarial", brick, 3_000),
             ("hash/adversarial sdf", hash_sdf, 3_000),
             ("odd/adversarial in 13", [tuple(odd)], 3_000)]
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731

    def lib_fwd(x, heads):
        return [torch.relu(bf(x) @ bf(w0)) @ bf(w1) for w0, w1, _ in heads]

    def lib_bwd(x, heads, g, wgrad=True):
        outs, col = [], 0
        for w0, w1, _ in heads:
            gb = bf(g[:, col:col + w1.shape[1]])
            col += w1.shape[1]
            z = gb @ bf(w1).t()
            outs.append(z @ bf(w0).t())
            if wgrad:
                h = bf(torch.relu(bf(x) @ bf(w0)))
                outs += [bf(x).t() @ z, h.t() @ gb]
        return outs

    for i, (tag, heads, n) in enumerate(cases):
        adversarial = "adversarial" in tag
        in_dim = heads[0][0].shape[0]
        out_cols = sum(w1.shape[1] for _, w1, _ in heads)
        x = torch.as_tensor(k4_features(n, in_dim, 100 + i,
                                        adversarial)).to(device)
        g = torch.randn(n, out_cols, generator=gen).to(device)
        terms = k4_terms(x, heads, g)
        out_k = fm.mlp_fwd(x, heads)
        gx_k, dw_k = fm.mlp_bwd(x, heads, g, True)
        ref = k4_outputs(fm.mlp_fwd_plain(x, heads),
                         *fm.mlp_bwd_plain(x, heads, g, True))
        gx_k2, dw_k2 = fm.mlp_bwd(x, heads, g, True)
        gx_n, none = fm.mlp_bwd(x, heads, g, False)
        names = ["out", "g_x"] + [f"dW{j}[{hi}]" for hi in range(len(heads))
                                  for j in (0, 1)]
        ours = k4_outputs(out_k, gx_k, dw_k)
        fits = dict(zip(names, k4_fits(ours, ref, terms)))
        for (name, fit), o, r in zip(fits.items(), ours, ref):
            fit["max_abs_err"] = float((o - r).abs().max())
            if not fit.pop("ok"):
                raise AssertionError(f"K4 {tag} {name}: {fit}")
        errs = {k: f["max_abs_err"] for k, f in fits.items()}
        controls = {}
        if not adversarial:
            for skip in K4_CONTROLS:
                other = k4_control(x, heads, g, skip)
                fs = k4_fits(other, ref, terms)
                passed = all(f["ok"] for f in fs)
                controls[skip] = {
                    "passes": passed,
                    "ratio": max(f["ratio"] for f in fs),
                    "off_share": max(f["off"] / f["n"] for f in fs)}
                if passed != (skip == "f64"):
                    raise AssertionError(
                        f"K4 {tag}: the check's control {skip} "
                        f"{'passed' if passed else 'failed'}: "
                        f"{controls[skip]}")
            del other
        repeat = torch.equal(gx_k, gx_k2) and all(
            torch.equal(a, b) for pa, pb in zip(dw_k, dw_k2)
            for a, b in zip(pa, pb))
        if not repeat or none is not None or not torch.equal(gx_k, gx_n):
            raise AssertionError(f"K4 {tag}: backward not bitwise equal on "
                                 "a repeat or without weight gradients")
        n_w = sum(w0.numel() + w1.numel() for w0, w1, _ in heads)
        macs = n * sum(w0.numel() + w1.numel() for w0, w1, _ in heads)
        rec = {"shape": f"{tag} N={n} in={in_dim} heads={len(heads)}",
               "max_abs_err": max(errs.values()), "max_abs_errs": errs,
               "misfit": fits, "controls": controls, "bitwise_repeat": True}
        rec_b = dict(rec)
        rec_n = {"shape": rec["shape"] + " no wgrad",
                 "max_abs_err": errs["g_x"]}
        if not adversarial:
            rec.update(timing(lambda: fm.mlp_fwd(x, heads),
                              lambda: fm.mlp_fwd_plain(x, heads), device,
                              n * (in_dim + out_cols) * 4 + n_w * 4,
                              2 * macs, flops_rate=BF16_FLOPS))
            rec["library_ms"] = timed(lambda: lib_fwd(x, heads), device)
            rec["library"] = "bf16 torch.matmul, 2 a head (reference point)"
            rec_b.update(timing(
                lambda: fm.mlp_bwd(x, heads, g, True),
                lambda: fm.mlp_bwd_plain(x, heads, g, True), device,
                n * (2 * in_dim + out_cols) * 4 + 2 * n_w * 4, 2 * 3 * macs,
                plain_iters=5, flops_rate=BF16_FLOPS))
            rec_b["library_ms"] = timed(lambda: lib_bwd(x, heads, g), device)
            rec_b["library"] = ("bf16 torch.matmul, 5 a head with the hidden "
                                "layer recomputed (reference point)")
            rec_n.update(timing(
                lambda: fm.mlp_bwd(x, heads, g, False),
                lambda: fm.mlp_bwd_plain(x, heads, g, False), device,
                n * (2 * in_dim + out_cols) * 4 + n_w * 4, 2 * 2 * macs,
                plain_iters=5, flops_rate=BF16_FLOPS))
            rec_n["library_ms"] = timed(lambda: lib_bwd(x, heads, g, False),
                                        device)
            rec_n["library"] = ("bf16 torch.matmul, 2 a head (reference "
                                "point)")
            # the floor of the f32 bytes this call moves: x read, an f32
            # (N, in) written, as one PyTorch copy (the yardstick writes
            # bf16 and moves about half of them)
            buf = torch.empty_like(x)
            rec_n["copy_ms"] = timed(lambda: buf.copy_(x), device)
            del buf
        rec_b["shape"] += " +wgrad"
        results["fused_mlp_fwd"].append(rec)
        results["fused_mlp_bwd"] += [rec_b, rec_n]
        del x, g, terms, ref, out_k, gx_k, gx_k2, gx_n
    return results


def k7_inputs(shape, device, seed: int):
    """A table leaf's (p, g, m, v) from `seed`: params at trained-table
    scale, gradients at 1e-6 .. 1e-2, bf16 moments of a running Adam, and
    in about one element of 10,000 each a NaN, +inf or -inf gradient and a
    NaN or inf first and second moment."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    p = (torch.rand(shape, generator=gen) * 0.6 - 0.3)
    g = torch.randn(shape, generator=gen) * 10.0 ** (
        torch.rand(shape, generator=gen) * 4 - 6)
    m = (g * 0.3 + torch.randn(shape, generator=gen) * 1e-4).to(
        torch.bfloat16)
    v = (g * g + torch.rand(shape, generator=gen) * 1e-8).to(torch.bfloat16)
    n = p.numel()
    k = max(n // 10_000, 1)
    pick = torch.randperm(n, generator=gen)[:3 * k]
    vals = torch.tensor([float("nan"), float("inf"), float("-inf")])
    g.view(-1)[pick] = vals.repeat_interleave(k)
    m.view(-1)[pick[:k]] = float("nan")
    m.view(-1)[torch.randperm(n, generator=gen)[:k]] = float("inf")
    v.view(-1)[torch.randperm(n, generator=gen)[:k]] = float("nan")
    v.view(-1)[torch.randperm(n, generator=gen)[:k]] = float("inf")
    return tuple(t.to(device) for t in (p, g, m, v))


def check_k7(shapes: dict, device) -> dict:
    """bf16-state Adam (K7) on the drives' table leaves (`shapes`: name ->
    shape; the brick table, the hash SDF and colour tables) from
    `k7_inputs`, at counts 1, 2 and 30, lr_scale 1 and 5: params and both
    moments BITWISE equal to the plain version (`core.optim.adam_lp_plain`)
    on the card, NaN and inf elements included. Then on the second half of
    each leaf's rows with its first element as the offset (a row block of
    `parallel.shard_tables`): bitwise equal to the plain version with that
    offset and to the same rows of K7 stepping the whole leaf. Timed at
    count 2, lr_scale 1 (the drives' steady state); the bound is 20 bytes
    an element.
    `library_ms`: one step of
    `torch.optim.Adam(fused=True)` on the same leaf with f32 moments, a
    different function (28 bytes an element), as a reference point."""
    import torch
    from unislam_tpu_torch.core import optim
    from unislam_tpu_torch.kernels import adam_lp as k7
    from unislam_tpu_torch.parallel import sharding

    bits = lambda t: t.view(torch.int16 if t.element_size() == 2  # noqa: E731
                            else torch.int32)
    combos = [(1, 5.0), (2, 1.0), (30, 1.0), (30, 5.0), (2, 5.0)]
    results = []
    for i, (name, shape) in enumerate(shapes.items()):
        p, g, m, v = k7_inputs(shape, device, 40 + i)
        n = p.numel()
        for count, lr_scale in combos:
            s = optim.step_scalars(count, 0, 0.05, lr_scale)
            pk, mk, vk = p.clone(), m.clone(), v.clone()
            k7.adam_lp_step(pk, g, mk, vk, s)
            pp, mp, vp = optim.adam_lp_plain(p, g, m, v, s)
            ok = all(torch.equal(bits(a), bits(b))
                     for a, b in ((pk, pp), (mk, mp), (vk, vp)))
            if not ok:
                diff = int((bits(pk) != bits(pp)).sum() + (bits(mk) != bits(
                    mp)).sum() + (bits(vk) != bits(vp)).sum())
                raise AssertionError(f"K7 {name} count={count} lr_scale="
                                     f"{lr_scale}: {diff} elements differ "
                                     "from the plain version")
        # a row block of the leaf (rank 1 of 2, as `parallel.shard_tables`
        # gives it) with its first element as the offset: bitwise equal to
        # the plain version with that offset and to the same rows of a
        # step of the whole leaf
        a, b = sharding.table_row_block(shape[0], 1, 2)
        off = a * (n // shape[0])
        s = optim.step_scalars(2, 0, 0.05, 5.0)
        pw, mw, vw = p.clone(), m.clone(), v.clone()
        k7.adam_lp_step(pw, g, mw, vw, s)
        blk = [t[a:b].clone() for t in (p, g, m, v)]
        k7.adam_lp_step(*blk, s, off)
        plain = optim.adam_lp_plain(p[a:b], g[a:b], m[a:b], v[a:b], s,
                                    offset=off)
        for what, ref in (("the plain version", plain),
                          ("the whole leaf's rows", (pw[a:b], mw[a:b],
                                                     vw[a:b]))):
            if not all(torch.equal(bits(x), bits(y)) for x, y in
                       zip((blk[0], blk[2], blk[3]), ref)):
                raise AssertionError(f"K7 {name} rows {a}:{b} (offset "
                                     f"{off}) differ from {what}")
        del pw, mw, vw, blk, plain
        s = optim.step_scalars(2, 0, 0.05)
        pk, mk, vk = p.clone(), m.clone(), v.clone()
        rec = {"shape": f"{name} {tuple(shape)} n={n}", "max_abs_err": 0.0,
               "bitwise_vs_plain": True,
               "offset_block_bitwise": {"rows": [a, b], "offset": off},
               "non_finite_inputs": int((~torch.isfinite(g)).sum()
                                        + (~torch.isfinite(m.float())).sum()
                                        + (~torch.isfinite(v.float())).sum()),
               "cases": len(combos)}
        rec.update(timing(lambda: k7.adam_lp_step(pk, g, mk, vk, s),
                          lambda: optim.adam_lp_plain(p, g, m, v, s), device,
                          20 * n, 30 * n, plain_iters=5))
        pl = p.clone().requires_grad_(True)
        pl.grad = torch.where(torch.isfinite(g), g, 0.0)
        adam = torch.optim.Adam([pl], lr=0.05, fused=True)
        rec["library_ms"] = timed(adam.step, device)
        rec["library"] = "torch.optim.Adam(fused=True), f32 moments"
        results.append(rec)
        del p, g, m, v, pk, mk, vk, pl, adam
        torch.cuda.empty_cache()
    return {"adam_lp": results}


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


def band_groups(slam) -> int:
    """Band groups of a mapping render (0 without the surface LOD): one,
    or two with a narrower mid band (`rendering.n_fine_mid`)."""
    import torch
    from unislam_tpu_torch.models import brick_encoding as be
    from unislam_tpu_torch.models import scene as scene_lib
    from unislam_tpu_torch.render.renderer import _lod_mode

    rc = slam.rc
    if not _lod_mode(slam.sc, rc, rc.n_stratified + rc.n_importance)[0]:
        return 0
    fine = be.coarse_fine_split(slam.sc.brick_spec, rc.lod_split)[1]
    return len(scene_lib._fine_groups(
        fine, torch.zeros(1, rc.n_fine, dtype=torch.long), rc.n_fine_mid))


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
    brick = slam.sc.encoding == "brick"
    expected = expected_launches(
        slam.sc.encoding, slam.sc.mlp_variant, mc.adam_state_dtype,
        band_groups(slam) if brick and slam.rc.dedup_band > 0 else 0, it)
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


def expected_launches(encoding: str, mlp_variant: str, adam_dtype: str,
                      dedup_groups: int, it: dict) -> dict:
    """The kernel launches that the iterations `it` (track, map, probe)
    imply."""
    if encoding == "brick":
        # a render is one encode_multi of two groups (the coarse levels at
        # every sample, the fine levels at the band): one grouped K5, a K6
        # per group; the probe encodes the coarse levels without a
        # backward; one K9 per mapping backward
        expected = {"brick_encode_fwd": it["track"] + it["map"]
                    + it["probe"],
                    "brick_encode_bwd": 2 * (it["track"] + it["map"]),
                    "scatter_accumulate": it["map"]}
    else:
        # one encode per hash grid (SDF, color) per render
        expected = {"hash_encode_fwd": 2 * (it["track"] + it["map"])
                    + it["probe"],
                    "hash_encode_bwd": 2 * (it["track"] + it["map"]),
                    "scatter_accumulate": 2 * it["map"]}
    # the fused decoders: a render decodes both heads in one K4 launch a
    # direction (brick: shared features) or one a head (hash); the probe
    # runs the SDF head forward. bf16-state Adam: one K7 a table a step
    brick = encoding == "brick"
    if mlp_variant == "fused":
        heads = 1 if brick else 2
        expected["fused_mlp_fwd"] = heads * (it["track"] + it["map"]) \
            + it["probe"]
        expected["fused_mlp_bwd"] = heads * (it["track"] + it["map"])
    if adam_dtype == "bfloat16":
        expected["adam_lp"] = (1 if brick else 2) * it["map"]
    # the band row dedup: one K8 a band group a mapping backward
    if dedup_groups:
        expected["band_dedup"] = dedup_groups * it["map"]
    # compositing: one K3 forward and one backward a render, and one K3 in
    # probe mode (counted as a forward) a probe iteration
    expected["composite_fwd"] = it["track"] + it["map"] + it["probe"]
    expected["composite_bwd"] = it["track"] + it["map"]
    return expected


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
        iters0 = dict(slam.iters_run)
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

        report[name] = {"iters": {k: v - iters0[k]
                                  for k, v in slam.iters_run.items()},
                        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                        "device_idle_share": 1.0 - busy_ms / wall_ms,
                        # each sync makes the host wait for the device
                        "host_syncs": count("cudaStreamSynchronize",
                                            "cudaDeviceSynchronize"),
                        "kernel_launches": count("cudaLaunchKernel",
                                                 "cudaLaunchKernelExC",
                                                 "cuLaunchKernel"),
                        "top": [{"kernel": k[:90], "device_ms": us / 1e3,
                                 "calls": c} for us, k, c in rows[:14]],
                        # the port's own kernels (csrc/), wherever they rank
                        "ours": [{"kernel": k[:90], "device_ms": us / 1e3,
                                  "calls": c} for us, k, c in rows
                                 if k.removeprefix("void ").startswith(
                                     OUR_KERNELS)]}
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
    "fused_mlp_fwd": ("unislam_tpu_torch/csrc/fused_mlp.cu",
                      "unislam_tpu/models/decoders.py:72"),
    "fused_mlp_bwd": ("unislam_tpu_torch/csrc/fused_mlp.cu",
                      "unislam_tpu/models/decoders.py:72"),
    "adam_lp": ("unislam_tpu_torch/csrc/adam_lp.cu",
                "unislam_tpu/core/optim.py:43"),
    "band_dedup": ("unislam_tpu_torch/csrc/band_dedup.cu",
                   "unislam_tpu/models/brick_encoding.py:515"),
    "composite_fwd": ("unislam_tpu_torch/csrc/composite.cu",
                      "unislam_tpu/render/renderer.py:85"),
    "composite_bwd": ("unislam_tpu_torch/csrc/composite.cu",
                      "unislam_tpu/render/renderer.py:85"),
}
# the shape whose times head the `kernels` line (all are in the JSON file)
HEADLINE = {"hash_encode_fwd": "color/map", "hash_encode_bwd": "color/map",
            "scatter_accumulate": "brick/map",
            "brick_encode_fwd": "grouped map",
            "brick_encode_bwd": "map/coarse",
            "fused_mlp_fwd": "brick/map", "fused_mlp_bwd": "brick/map",
            "adam_lp": "brick", "band_dedup": "map Ku=8",
            "composite_fwd": "map R=", "composite_bwd": "map loop"}


def mesh_and_render(slam, cfg, frame_list, device) -> dict:
    """The brick drive's final map through the port's `Mesher` (LOD
    two-pass at BRICK_MESH_RES over marching_cubes_bound) and one full
    image through `render_img` at the last frame's estimated pose. The
    launch counts are set to 0 just before each and read just after: K5
    must launch once per 500,000-point batch of each pass and of the
    vertex colours, and once per render chunk (plus one per chunk with a
    pixel without depth, for the probe), and K3 forward as often (a
    composite a chunk, the probe's weights a chunk without depth). Raises
    on an empty mesh, a non-finite render or a launch count off its
    expectation."""
    import resource

    import numpy as np
    import torch
    from unislam_tpu_torch.core import rng
    from unislam_tpu_torch.kernels import build
    from unislam_tpu_torch.render.renderer import render_img
    from unislam_tpu_torch.utils.mesher import Mesher

    cfg = {**cfg, "meshing": {**cfg["meshing"],
                              "resolution": BRICK_MESH_RES}}
    mesher = Mesher(cfg, slam.sc, slam.intr)
    bs = mesher.points_batch_size
    path = os.path.join(REPO, "build", "smoke_brick_mesh.ply")
    build.reset_launches()
    t0 = time.perf_counter()
    out = mesher.get_mesh(path, slam.params, slam.bank, verbose=True)
    mesh_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    st = dict(mesher.stats)
    if out is None or not st.get("faces"):
        raise AssertionError(f"mesh brick: no mesh ({st})")
    os.remove(path)
    expected = (math.ceil(st["coarse_points"] / bs)
                + math.ceil(st["fine_points"] / bs)
                + math.ceil(st["marching_vertices"] / bs))
    rec = {"mesh_s": mesh_s, **st,
           "grid_points_queried": st["coarse_points"] + st["fine_points"],
           "k5_launches": launches.get("brick_encode_fwd", 0),
           "k5_launches_expected": expected,
           "host_max_rss_gb": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss / 1e6}
    if launches != {"brick_encode_fwd": expected}:
        raise AssertionError(f"mesh brick: launches {launches}, expected "
                             f"{expected} K5")

    idx = slam.n_img - 1
    color, depth, _ = frame_list[idx]
    rc = slam.rc._replace(perturb=False)
    chunk = rc.ray_batch_size
    n = slam.intr.H * slam.intr.W
    holes = np.concatenate([np.asarray(depth).reshape(-1) <= 0,
                            np.zeros((-n) % chunk, bool)])
    expected = n // chunk + (n % chunk > 0) + int(
        holes.reshape(-1, chunk).any(1).sum())
    ms = []
    for _ in range(2):
        build.reset_launches()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        r_depth, r_rgb, term, unc, dstd = render_img(
            slam.params, slam.sc, rc, slam.intr, slam.est_c2w[idx],
            rng.generator(123, device), gt_depth=depth)
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(build.LAUNCHES)
    outs = (r_depth, r_rgb, term, unc, dstd)
    H, W = slam.intr.H, slam.intr.W
    if [tuple(o.shape) for o in outs] != [(H, W), (H, W, 3), (H, W), (H, W),
                                          (H, W)] or not all(
            bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError("render_img brick: wrong shape or not finite")
    if launches != {"brick_encode_fwd": expected, "composite_fwd": expected}:
        raise AssertionError(f"render_img brick: launches {launches}, "
                             f"expected {expected} K5 and K3")
    r_rgb = r_rgb.cpu().numpy()
    mse = float(np.mean((np.asarray(color) - r_rgb) ** 2))
    rec.update(render_ms=ms, render_k5_launches=launches["brick_encode_fwd"],
               render_k5_launches_expected=expected,
               render_k3_launches=launches["composite_fwd"],
               render_psnr=-10 * math.log10(mse),
               render_depth_l1=float(np.abs(
                   r_depth.cpu().numpy() - np.asarray(depth)).mean()))
    return rec


def _json_lines(path: str) -> list:
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return out


def cli_drive(setup, frame_list, out_dir: str, card: str) -> dict:
    """The CLI on recorded frames: `python -m unislam_tpu_torch.run` as a
    subprocess, on the card (no --device), with the hash config the JAX
    package's `run.py` defaults to, configs/Replica/room0.yaml.

    The room0-scale scene's frames are written to disk in Replica's layout
    (`synthetic.write_replica`: results/frame%06d.jpg, depth%06d.png as
    16-bit at png_depth_scale 6553.5, traj.txt) under build/cli_smoke. The
    colour files are lossless PNG bytes under the Replica names, so the
    CLI reads the drives' frames up to 8-bit rounding; cv2.imread picks the
    decoder from the content. A YAML inherits room0.yaml and sets only
    mapping.bound and marching_cubes_bound to the scene's bound, and the
    data paths. Run 1 takes the first 60% of the frames and ends with a
    checkpoint, the final mesh, the culled mesh and the rendering
    evaluation; run 2 resumes (--resume) and ends the same way after all
    of them.

    Checks: both runs exit 0; run 2 starts where run 1 stopped; the ATE
    over all frames (output.txt) is under 3 cm; the final and culled meshes
    have faces; one rendered image per 5 frames; PSNR, MS-SSIM and the
    render depth L1 are finite; the frame loops read no frame twice; each
    mesh made one K1 launch per 500,000-point SDF batch and two per
    vertex-colour batch, and each evaluated image two per render chunk
    (plus one per chunk with a pixel without depth) and one K3 forward per
    chunk (plus one in probe mode per chunk with a pixel without depth)."""
    import shutil

    import numpy as np
    import yaml
    from unislam_tpu_torch.data.synthetic import write_replica
    from unislam_tpu_torch.utils import mesh_io

    cfg, ds = setup
    n_frames = len(frame_list)
    n_first = n_frames * 6 // 10
    work = os.path.join(REPO, "build", "cli_smoke")
    shutil.rmtree(work, ignore_errors=True)
    room, output = os.path.join(work, "room"), os.path.join(work, "output")
    t0 = time.perf_counter()
    write_replica(frame_list, room)
    rec = {"frames": n_frames, "resume_at": n_first,
           "write_s": time.perf_counter() - t0}
    bound = np.asarray(ds.bound, np.float64).tolist()
    cfg_path = os.path.join(work, "room0_smoke.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({
            "inherit_from": os.path.join(REPO, "configs/Replica/room0.yaml"),
            "mapping": {"bound": bound, "marching_cubes_bound": bound},
            "meshing": {"resolution": CLI_MESH_RES},
            "data": {"input_folder": room, "output": output}}, f)
    os.makedirs(os.path.join(out_dir, "cli"), exist_ok=True)
    runs = []
    for i, extra in enumerate((["--n_frames", str(n_first)],
                               ["--resume", "--n_frames", str(n_frames)])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "unislam_tpu_torch.run", cfg_path, *extra],
            cwd=REPO, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        with open(os.path.join(out_dir, "cli", f"run{i + 1}.log"), "w") as f:
            f.write(proc.stdout + "\n--- stderr\n" + proc.stderr)
        if proc.returncode != 0:
            raise AssertionError(f"cli run {i + 1} exited {proc.returncode}:"
                                 f"\n{proc.stderr[-3000:]}")
        with open(os.path.join(output, "runtime_stats.json")) as f:
            stats = json.load(f)
        shutil.copy(os.path.join(output, "runtime_stats.json"),
                    os.path.join(out_dir, "cli", f"run{i + 1}_stats.json"))
        runs.append((proc, wall, stats))
    shutil.copy(os.path.join(output, "output.txt"),
                os.path.join(out_dir, "cli", "output.txt"))

    (_, wall1, st1), (proc2, wall2, st2) = runs
    lines = _json_lines(os.path.join(output, "output.txt"))
    ate = [r for r in lines if "error.rmse" in r][-1]
    ev = [r for r in lines if "avg_psnr" in r][-1]
    mesh_dir = os.path.join(output, "mesh")
    meshes = sorted(m for m in os.listdir(mesh_dir) if m.startswith("final"))
    faces = {m: len(mesh_io.read_ply(os.path.join(mesh_dir, m))[1])
             for m in meshes}
    images = len(os.listdir(os.path.join(output, "rendered_image")))

    # expected K1 launches per mesh and per evaluated image
    bs = 500_000
    chunk = 10_000
    H, W = ds.intr.H, ds.intr.W
    n_px = H * W
    n_chunks = -(-n_px // chunk)
    pad = n_chunks * chunk - n_px
    per_image = []      # (K1, K3) a rendered image
    for idx in range(0, n_frames, 5):
        d16 = (np.asarray(frame_list[idx][1]) * 6553.5).astype(np.uint16)
        holes = np.concatenate([d16.reshape(-1) == 0, np.zeros(pad, bool)])
        n_holes = int(holes.reshape(-1, chunk).any(1).sum())
        per_image.append((2 * n_chunks + n_holes, n_chunks + n_holes))
    mesh_recs = []
    for st in (st1, st2):
        for m in st["meshes"]:
            exp = (math.ceil(m["coarse_points"] / bs)
                   + math.ceil(m["fine_points"] / bs)
                   + 2 * math.ceil(m["marching_vertices"] / bs))
            mesh_recs.append({k: m[k] for k in (
                "mode", "grid_points", "coarse_points", "fine_points",
                "pass1_s", "band_s", "pass2_s", "marching_s", "color_s",
                "bound_cull_s", "vertices", "faces")}
                | {"k1_launches": m["launches"].get("hash_encode_fwd", 0),
                   "k1_launches_expected": exp})
    evals = []
    for st, frames_run in ((st1, n_first), (st2, n_frames)):
        n_img = len(range(0, frames_run, 5))
        ev_launches = st["launches"]["eval_rendering"]
        evals.append({
            "images": st["render_img"]["images"],
            "render_img_ms_per_image": st["render_img"]["render_s"] * 1e3
            / st["render_img"]["images"],
            "k1_launches": ev_launches.get("hash_encode_fwd", 0),
            "k1_launches_expected": sum(p[0] for p in per_image[:n_img]),
            "k3_launches": ev_launches.get("composite_fwd", 0),
            "k3_launches_expected": sum(p[1] for p in per_image[:n_img])})
    rec.update({
        "run_wall_s": [wall1, wall2],
        "phases_s": [st1["phases_s"], st2["phases_s"]],
        "start_frames": [st1["start_frame"], st2["start_frame"]],
        "frame_reads": [st1["frame_reads"], st2["frame_reads"]],
        "host_max_rss_gb": [st1["host_max_rss_gb"], st2["host_max_rss_gb"]],
        "ate_cm": ate, "eval": ev, "final_meshes_faces": faces,
        "rendered_images": images, "meshes": mesh_recs, "evals": evals,
        "launches_run": [st1["launches_run"], st2["launches_run"]]})
    print("drive cli " + json.dumps(rec), flush=True)

    bad = []
    if st2["start_frame"] != n_first or "resumed from" not in proc2.stdout:
        bad.append(f"run 2 started at {st2['start_frame']}, not {n_first}")
    if ate["compared_pose_pairs"] != n_frames or not (
            math.isfinite(ate["error.rmse"]) and ate["error.rmse"] < 3.0):
        bad.append(f"ATE {ate}")
    if len(faces) != 2 or not all(faces.values()):
        bad.append(f"final meshes {faces}")
    if images != len(range(0, n_frames, 5)):
        bad.append(f"{images} rendered images")
    if not all(isinstance(ev.get(k), float) and math.isfinite(ev[k])
               for k in ("avg_psnr", "avg_ms_ssim", "depth_l1_render")):
        bad.append(f"eval numbers {ev}")
    reads = [st1["frame_reads"], st2["frame_reads"]]
    if reads != [{"frames": n_first, "max": 1},
                 {"frames": n_frames - n_first, "max": 1}]:
        bad.append(f"frame reads {reads}")
    if any(m["k1_launches"] != m["k1_launches_expected"] for m in mesh_recs):
        bad.append("K1 launches per mesh")
    if any(m["mode"] != "hierarchical" for m in mesh_recs):
        bad.append("a mesh without the hierarchical pass")
    if any(e["k1_launches"] != e["k1_launches_expected"] for e in evals):
        bad.append("K1 launches per evaluated image")
    if any(e["k3_launches"] != e["k3_launches_expected"] for e in evals):
        bad.append("K3 launches per evaluated image")
    for st in (st1, st2):
        if not all(st["launches_run"].get(k, 0) > 0 for k in (
                "hash_encode_fwd", "hash_encode_bwd", "scatter_accumulate",
                "composite_fwd", "composite_bwd")):
            bad.append(f"kernels not launched: {st['launches_run']}")
    if bad:
        raise AssertionError("drive cli: " + "; ".join(bad))
    rec["viewer"] = viewer_phase(cfg_path, output, n_frames, out_dir, card)
    shutil.rmtree(work)
    return rec


def _viewer_pngs(vis_dir: str) -> list:
    """The PNGs under `vis_dir`, each checked: 480 x 640 x 3, with at least
    1% of its pixels coloured by the mesh's bone shading (black is the
    background, and the overlay is lime, cyan or red)."""
    import cv2
    import numpy as np

    pngs = sorted(f for f in os.listdir(vis_dir) if f.endswith(".png"))
    for name in pngs:
        img = cv2.imread(os.path.join(vis_dir, name))
        if img is None or img.shape != (480, 640, 3):
            raise AssertionError(f"viewer: {name} reads as "
                                 f"{None if img is None else img.shape}")
        b, g, r = (img[..., k].astype(np.int16) for k in range(3))
        bone = (b >= g) & (g >= r) & (b > r) & (g < 255)
        if bone.mean() < 0.01:
            raise AssertionError(f"viewer: {name} shows no mesh shading "
                                 f"({float(bone.mean())} of its pixels)")
    return pngs


def viewer_phase(cfg_path: str, output: str, n_frames: int, out_dir: str,
                 card: str) -> dict:
    """The viewer half of the visualisation on the `cli` drive's run
    directory (checkpoints to the last of its `n_frames` frames, live.json,
    the final mesh): `python -m unislam_tpu_torch.visualizer` as a
    subprocess with `--every 20` (a PNG every 20th frame), again with
    `--incremental` (no snapshot at mesh_freq 100000: each view falls back
    to the newest mesh) and once with `--mp4` (reported, not required: the
    host's cv2 may lack an mp4 encoder); `playback.follow_live(once=True)`
    (one PNG); and `webviewer.start_background` on a free port: `/` is the
    page, `/state` the run at its last frame with the newest mesh's name,
    `/mesh/<it>` the file's bytes, `/mesh/..%2Fckpts` 404. Host code only.
    Prints one `viewer` line with `card`, the card's name and power limit;
    raises on any miss."""
    import shutil
    import urllib.error
    import urllib.request

    from unislam_tpu_torch.utils import playback, webviewer

    vis_dir = os.path.join(output, "playback")
    os.makedirs(os.path.join(out_dir, "cli"), exist_ok=True)
    rec, logs = {}, []
    for mode, extra in (("playback", []), ("incremental", ["--incremental"]),
                        ("mp4", ["--mp4"])):
        shutil.rmtree(vis_dir, ignore_errors=True)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "unislam_tpu_torch.visualizer", cfg_path,
             "--output", output, "--every", "20", *extra], cwd=REPO,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        logs.append(f"--- {mode}\n{proc.stdout}\n--- stderr\n{proc.stderr}")
        if proc.returncode != 0:
            raise AssertionError(f"viewer {mode} exited {proc.returncode}:"
                                 f"\n{proc.stderr[-3000:]}")
        pngs = _viewer_pngs(vis_dir)
        rec[mode] = {"pngs": len(pngs), "wall_s": wall,
                     "s_per_view": wall / max(len(pngs), 1)}
    with open(os.path.join(out_dir, "cli", "viewer.log"), "w") as f:
        f.write("\n".join(logs))
    # the last run's last line says whether the mp4 was written
    rec["mp4"]["written"] = proc.stdout.strip().splitlines()[-1] == \
        f"wrote {vis_dir}/playback.mp4"

    t0 = time.perf_counter()
    live = playback.follow_live(output, once=True)
    rec["live"] = {"pngs": len(live), "s_per_view": time.perf_counter() - t0}
    _viewer_pngs(os.path.join(output, "live_view"))

    newest = playback.newest_mesh(os.path.join(output, "mesh"))
    srv = webviewer.start_background(output, port=0)
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path):
        try:
            with urllib.request.urlopen(base + path, timeout=60) as r:
                return r.status, r.headers.get("Content-Type"), r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Content-Type"), e.read()

    try:
        web = {p: get(p) for p in ("/", "/state",
                                   "/mesh/" + os.path.basename(newest),
                                   "/mesh/..%2Fckpts")}
    finally:
        srv.shutdown()
        srv.server_close()
    page, state, mesh, trav = web.values()
    st = json.loads(state[2]) if state[0] == 200 else {}
    with open(newest, "rb") as f:
        mesh_equal = mesh[0] == 200 and mesh[2] == f.read()
    rec["web"] = {"page": page[:2], "state": state[0],
                  "state_frame": st.get("frame"), "state_n_img":
                  st.get("n_img"), "state_est_t": len(st.get("est_t", [])),
                  "state_mesh": st.get("mesh"), "mesh_bytes": len(mesh[2]),
                  "mesh_equal": mesh_equal, "traversal": trav[0]}
    rec["card"] = card
    print("viewer " + json.dumps(rec), flush=True)

    n_views = len(range(0, n_frames, 20))
    bad = [f"{m}: {rec[m]['pngs']} PNGs" for m, n in
           (("playback", n_views), ("incremental", n_views),
            ("mp4", n_views), ("live", 1)) if rec[m]["pngs"] != n]
    w = rec["web"]
    if page[0] != 200 or not page[1].startswith("text/html") or \
            b"parsePLY" not in page[2]:
        bad.append(f"/ answered {page[:2]}")
    if (w["state"], w["state_frame"], w["state_n_img"], w["state_est_t"],
            w["state_mesh"]) != (200, n_frames - 1, n_frames, n_frames,
                                 os.path.basename(newest)):
        bad.append(f"/state {w}")
    if not mesh_equal:
        bad.append(f"/mesh answered {mesh[0]}, {len(mesh[2])} bytes")
    if trav[0] != 404:
        bad.append(f"/mesh/..%2Fckpts answered {trav[0]}")
    if bad:
        raise AssertionError("viewer: " + "; ".join(bad))
    return rec


# Each drive's ATE bar (cm): 3 cm, the verify bar, for the hash and brick
# drives. brick_lowp's is the median ATE of the JAX package's own loop
# with both options on this scene and config over the drive's 200 frames
# (scripts/lowp_jax_witness.py --variants both --frames 200, seeds 0-3 on
# the CPU: 2.35, 12.07, 4.66 and 3.44 cm): at this scene the loop
# loses tracking on some seeds, with or without the options, in the
# reference as in the port (PERF.md, section 6), so the drive is held to
# a typical reference run of the same configuration. brick_dedup's is the
# larger of 3 cm and the same median for its drive, fixed before the
# drive's first run on the card (scripts/dedup_jax_witness.py, 200
# frames, seeds 0-3 on the CPU: 13.99, 8.11, 124.28 and 1.45 cm).
# hash_holes's is the larger of 3 cm and the JAX package's median for its
# drive, fixed before the drive's first run on the card
# (scripts/holes_jax_witness.py, 200 frames, seeds 0-3 on the CPU: 0.69,
# 5.70, 5.31 and 2.69 cm). brick_holes's is the larger of 3 cm and the
# JAX package's median for its drive, fixed before the drive's first run
# on the card (scripts/brick_holes_jax_witness.py, 200 frames, seeds 0-3
# on the CPU: 1.96, 45.45, 119.06 and 1.74 cm: the reference's brick loop
# loses tracking on two of the four seeds with these holes).
ATE_BAR_CM = {"hash": 3.0, "brick": 3.0, "brick_lowp": 4.05,
              "brick_dedup": 11.05, "hash_holes": 4.0,
              "brick_holes": 23.705}


def run_drive(name, cfg, frame_list, device, out_dir):
    """One drive and its profile; raises if the drive misses its bars."""
    slam, frames, launches, ate, wall_s = drive(cfg, frame_list, device)
    rep = drive_report(slam, frames, launches, ate, wall_s)
    rep["ate_bar_cm"] = bar = ATE_BAR_CM[name]
    it = rep["iters_run"]
    if name.endswith("_holes") and not it["probe"] == it["map"] > 0:
        # every keyframe has holes, so every mapping iteration probes
        raise AssertionError(f"drive {name}: the no-depth probe ran "
                             f"{it['probe']} of {it['map']} mapping "
                             "iterations")
    print(f"drive {name} " + json.dumps(
        {k: v for k, v in rep.items()
         if k not in ("tracked_frame_ms", "mapping_phase_ms")}), flush=True)
    ate_cm = ate["error.rmse"]
    if not math.isfinite(ate_cm) or ate_cm >= bar:
        raise AssertionError(f"drive {name}: ATE-RMSE {ate_cm} cm (bar: "
                             f"< {bar} cm)")
    if launches != rep["launches_expected"]:
        raise AssertionError(f"drive {name}: launches {launches} != "
                             f"expected {rep['launches_expected']}")
    prof = profile(slam, frame_list, device, out_dir, name)
    for pname, r in prof.items():
        print(f"profile {pname} " + json.dumps(r), flush=True)
    return rep, frames, prof, slam


# ---------------------------------------------------------------------------
# phase 7: multi-device (parallel.*)

# frames of the multi-device drives: the overlapped ones, dp_hash, the
# brick ones (held bit for bit to each other, not to a sequential run),
# and the NCCL one-rank run
DP_FRAMES = 40
DP_HASH_FRAMES = 16
DP_BRICK_FRAMES = 20
NCCL_FRAMES = 8
# ranks of the overlapped run: one tracking, the others mapping
OVERLAP_WORLD = 3
# trajectory bands against the sequential run on the same frames (the JAX
# package's own, tests/test_engine.py:277-281): every frame within 2 cm, the
# ATE within 1 cm; dp_hash and overlap_hash also under 3 cm (overlap_hash:
# the ATE bands only; dp_brick and dp_brick_rows: reported, and
# dp_brick_rows held bit for bit to dp_brick, see parallel_phase)
DP_FRAME_CM, DP_ATE_CM, DP_ABS_CM = 2.0, 1.0, 3.0
RANK_TIMEOUT_S = 420


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def write_rank_frames(frame_list, path: str) -> str:
    """The frames as color.npy, depth.npy and pose.npy under `path`, which
    every rank maps instead of rendering them again."""
    import numpy as np
    os.makedirs(path, exist_ok=True)
    for i, name in enumerate(("color", "depth", "pose")):
        np.save(os.path.join(path, f"{name}.npy"),
                np.stack([f[i] for f in frame_list]).astype(np.float32))
    return path


def _jsonable(x):
    import numpy as np
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def run_ranks(name: str, cfg, frames_dir: str, world: int, backend: str,
              n_frames: int, out_dir: str, overlap: bool = False) -> list:
    """`scripts/smoke_rank.py` as `world` processes on this card (each
    given RANK_TIMEOUT_S; with `overlap`, the overlapped driver's roles);
    returns their reports. A rank
    that exits non-zero or overruns fails the smoke; every rank is ended
    before this returns."""
    rank_dir = os.path.join(out_dir, f"dp_{name}")
    os.makedirs(rank_dir, exist_ok=True)
    cfg_path = os.path.join(rank_dir, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(_jsonable(cfg), f)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(os.path.join(rank_dir, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, "scripts",
                                              "smoke_rank.py"),
                 str(port), str(world), str(r), cfg_path, frames_dir,
                 rank_dir, "--n-frames", str(n_frames), "--backend",
                 backend, "--timeout", str(RANK_TIMEOUT_S)]
                + (["--overlap"] if overlap else []),
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        for r, p in enumerate(procs):
            left = RANK_TIMEOUT_S + 60 - (time.perf_counter() - t0)
            try:
                p.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name}: rank {r} did not end within "
                                     f"{RANK_TIMEOUT_S + 60} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    reports = []
    for r, p in enumerate(procs):
        path = os.path.join(rank_dir, f"rank{r}.json")
        if p.returncode != 0 or not os.path.exists(path):
            with open(os.path.join(rank_dir, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            detail = ""
            if os.path.exists(path):
                with open(path) as f:
                    detail = json.dumps(json.load(f)["first_step"])[:3000]
            raise AssertionError(f"{name}: rank {r} exited {p.returncode}:"
                                 f"\n{tail}\n{detail}")
        with open(path) as f:
            reports.append(json.load(f))
    return reports


def trajectory_bands(name, est, gt, ref_est, ref_ate_cm: float,
                     abs_cm=None, per_frame: bool = True,
                     held: bool = True) -> dict:
    """Each frame's position within DP_FRAME_CM of the reference run's
    (unless not `per_frame`) and the ATE within DP_ATE_CM of its ATE (and
    under `abs_cm`); raises if not, unless not `held` (then the numbers
    are reported and only a non-finite ATE fails)."""
    import numpy as np
    from unislam_tpu_torch.tools.eval_ate import pose_evaluation

    est = np.asarray(est, np.float32)
    n = len(est)
    frame_cm = np.linalg.norm(est[:, :3, 3] - ref_est[:n, :3, 3],
                              axis=1) * 100
    _, ate = pose_evaluation(gt[:n], est)
    out = {"ate_cm": ate["error.rmse"], "ref_ate_cm": ref_ate_cm,
           "max_frame_diff_cm": float(frame_cm.max()),
           "frame_band_cm": DP_FRAME_CM if per_frame else None,
           "ate_band_cm": DP_ATE_CM, "abs_bar_cm": abs_cm, "held": held}
    within = (frame_cm.max() <= DP_FRAME_CM or not per_frame) \
        and abs(out["ate_cm"] - ref_ate_cm) <= DP_ATE_CM \
        and (abs_cm is None or out["ate_cm"] <= abs_cm)
    out["within"] = bool(within)
    if not math.isfinite(out["ate_cm"]) or (held and not within):
        raise AssertionError(f"{name}: trajectory outside its bands {out}")
    return out


def check_ranks(name, cfg, reports, expect_rows=None) -> dict:
    """What every rank must show: the first step within its tolerances,
    the replicas compared after every mapping phase, launches exact, the
    same trajectory on every rank."""
    import numpy as np
    from unislam_tpu_torch.models import scene as scene_lib

    sc = scene_lib.make_scene_config(cfg)
    if cfg["rendering"].get("dedup_band", 0.0):
        raise ValueError("the multi-device drives run without the dedup")
    out = {"ranks": []}
    for rep in reports:
        it = rep["iters_run"]
        exp = expected_launches(sc.encoding, sc.mlp_variant,
                                cfg["mapping"].get("adam_state_dtype",
                                                   "float32"), 0, it)
        if rep["launches"] != exp:
            raise AssertionError(f"{name} rank {rep['rank']}: launches "
                                 f"{rep['launches']} != expected {exp}")
        if not rep["first_step"].get("ok"):
            raise AssertionError(f"{name} rank {rep['rank']}: first step "
                                 f"{rep['first_step']}")
        if rep["replica_checks"] != rep["mapping_cnt"]:
            raise AssertionError(f"{name} rank {rep['rank']}: "
                                 f"{rep['replica_checks']} replica checks "
                                 f"for {rep['mapping_cnt']} phases")
        if expect_rows is not None and {
                k: v["rows"][1] - v["rows"][0]
                for k, v in rep["table_rows"].items()} != expect_rows:
            raise AssertionError(f"{name} rank {rep['rank']}: rows "
                                 f"{rep['table_rows']}")
        out["ranks"].append({k: v for k, v in rep.items()
                             if k != "est_c2w"})
    est = [np.asarray(r["est_c2w"]) for r in reports]
    if any(not np.array_equal(e, est[0]) for e in est[1:]):
        raise AssertionError(f"{name}: the ranks' trajectories differ")
    out["est_c2w"] = est[0]
    out["scene_checksum"] = reports[0]["scene_checksum"]
    out["ba_frames"] = reports[0]["ba_frames"]
    return out


def check_overlap_ranks(name, cfg, reports) -> dict:
    """What the ranks of an overlapped run must show: rank 0 tracks and
    launches its tracking iterations' kernels only (no K9), ranks 1..N-1
    their mapping iterations' only; each mapping rank's first step within
    its tolerances and its replicas compared after every phase; one
    trajectory and as many seeds drawn on every rank; every rank mapped
    the same frames, which are
    the cadence's, the last and those the tracker's uncertainty trigger
    sent back (`frames_mapped_by_schedule`); the tracker's snapshot after
    the final `sync()` the mapping scene bit for bit; no tracked frame on
    a snapshot older than the previous phase's."""
    import numpy as np
    from unislam_tpu_torch.models import scene as scene_lib

    sc = scene_lib.make_scene_config(cfg)
    roles = [r["role"] for r in reports]
    if roles != ["track"] + ["map"] * (len(reports) - 1):
        raise AssertionError(f"{name}: roles {roles}")
    out = {"ranks": []}
    for rep in reports:
        it = rep["iters_run"]
        exp = {k: v for k, v in expected_launches(
            sc.encoding, sc.mlp_variant,
            cfg["mapping"].get("adam_state_dtype", "float32"), 0,
            it).items() if v}
        if rep["launches"] != exp:
            raise AssertionError(f"{name} rank {rep['global_rank']}: "
                                 f"launches {rep['launches']} != expected "
                                 f"{exp}")
        if rep["role"] == "track":
            ages = rep["snapshot_ages"]
            if it["map"] or "scatter_accumulate" in rep["launches"] \
                    or not ages or set(ages) - {"0", "1"}:
                raise AssertionError(f"{name}: the tracking rank ran "
                                     f"{it}, snapshot ages {ages}")
        else:
            if it["track"] or not rep["first_step"].get("ok"):
                raise AssertionError(f"{name} rank {rep['global_rank']}: "
                                     f"{it}, first step "
                                     f"{rep['first_step']}")
            if rep["replica_checks"] != rep["mapping_cnt"]:
                raise AssertionError(f"{name} rank {rep['global_rank']}: "
                                     f"{rep['replica_checks']} replica "
                                     f"checks for {rep['mapping_cnt']} "
                                     "phases")
        out["ranks"].append({k: v for k, v in rep.items()
                             if k not in ("est_c2w", "scene_checksum",
                                          "snapshot_phase",
                                          "snapshot_age")})
    est = [np.asarray(r["est_c2w"]) for r in reports]
    if any(not np.array_equal(e, est[0]) for e in est[1:]):
        raise AssertionError(f"{name}: the ranks' trajectories differ")
    seeds = [r["seeds_drawn"] for r in reports]
    if len(set(seeds)) != 1:
        raise AssertionError(f"{name}: seeds drawn {seeds}")
    same = [r["scene_checksum"] == reports[0]["scene_checksum"]
            for r in reports[1:]]
    out["snapshot_bitwise_mapping_scene"] = all(same)
    if not all(same):
        raise AssertionError(f"{name}: the tracker's final snapshot is not "
                             f"the mapping scene: {same}")
    mapped = [r["mapped_frames"] for r in reports]
    if any(m != mapped[0] for m in mapped[1:]) or not \
            frames_mapped_by_schedule(cfg, reports[0]["frames"],
                                      mapped[0], reports[0]["frame_iters"]):
        raise AssertionError(f"{name}: mapped frames {mapped}")
    out["est_c2w"] = est[0]
    out["mapping_cnt"] = reports[1]["mapping_cnt"]
    out["mapped_frames"] = mapped[0]
    out["ba_frames"] = reports[1]["ba_frames"]
    out["seeds_drawn"] = seeds[0]
    return out


def frames_mapped_by_schedule(cfg, n: int, mapped, track_iters) -> bool:
    """Whether `mapped` are frames that the driver's schedule maps: every
    `every_frame`-th frame and the last are mapped, and another frame only
    if the uncertainty trigger was on while it was tracked (it then ran
    more than the base iterations; `track_iters` holds each frame's)."""
    every = cfg["mapping"]["every_frame"]
    base = cfg["tracking"]["iters"]
    mapped = set(mapped)
    for idx in range(n):
        cadence = idx % every == 0 or idx == n - 1
        if cadence and idx not in mapped:
            return False
        if not cadence and idx in mapped and track_iters[idx] <= base:
            return False
    return True


def overlap_line(chk) -> dict:
    """The printed summary of an overlapped run: the tracking rank's
    tracked-frame ms, its waits at `sync()` and its snapshot ages; the
    mapping ranks' phase ms and all-reduces; rank 1's replies (bytes, ms
    from start to end); every rank's peak device memory."""
    import numpy as np
    track, maps = chk["ranks"][0], chk["ranks"][1:]
    replies = maps[0]["replies"]
    return {
        "trajectory": chk["trajectory"], "wall_s": chk["wall_s"],
        "mapping_cnt": chk["mapping_cnt"],
        "mapped_frames": chk["mapped_frames"],
        "sequential": chk["sequential"],
        "snapshot_bitwise_mapping_scene":
            chk["snapshot_bitwise_mapping_scene"],
        "tracked_frame_ms_mean": track["tracked_frame_ms_mean"],
        "tracked_frame_ms_steady": track["tracked_frame_ms_steady"],
        "sync_wait_ms": track["sync_wait_ms"],
        "snapshot_ages": track["snapshot_ages"],
        "reply_bytes": replies[0]["bytes"],
        "reply_ms": [r.get("ms") for r in replies],
        "reply_ms_mean": float(np.mean([r["ms"] for r in replies
                                        if "ms" in r])),
        "ranks": [{k: r[k] for k in (
            "global_rank", "role", "iters_run", "launches",
            "mapping_phase_ms_mean", "mapping_phase_ms_steady",
            "record_wait_ms_mean", "allreduce_per_map_iter",
            "replica_checks", "peak_device_bytes") if k in r}
            | ({"first_step_ok": r["first_step"]["ok"]}
               if r["first_step"] else {}) for r in chk["ranks"]]}


def overlap_drive(cfg, frame_list, device) -> dict:
    """`OverlappedSLAM` with tracking and mapping on this card: the loss
    (and, with joint BA, the BA pose) pending after every mapping frame
    until the next `map_frame` or `sync()`, launches exact."""
    import numpy as np
    import torch
    from unislam_tpu_torch.engine.overlap import OverlappedSLAM
    from unislam_tpu_torch.kernels import build

    slam = OverlappedSLAM(cfg, frame_list, seed=0, track_device=device,
                          map_devices=[device])
    build.reset_launches()
    pending = {"loss": 0, "ba": 0, "ba_landed": 0}
    t0 = time.perf_counter()
    for idx in range(slam.n_img):
        mapped = slam.step_frame(idx)
        if mapped:
            if slam._pending_loss is None:
                raise AssertionError(f"overlap_hash: no loss pending after "
                                     f"mapping frame {idx}")
            pending["loss"] += 1
            if slam._pending_ba is not None:
                pending["ba"] += 1
            if slam._pending_ba is not None and not pending["ba_landed"]:
                # the first BA pose: landed by sync() here (the later ones
                # land at the next map_frame, as they would in a run)
                i, _ = slam._pending_ba
                before = slam.est_c2w[i].copy()
                slam.sync()
                if slam._pending_ba is not None or \
                        slam._pending_loss is not None:
                    raise AssertionError("overlap_hash: sync() left work "
                                         "pending")
                pending["ba_landed"] = int(
                    not np.array_equal(before, slam.est_c2w[i]))
    slam.sync()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    it = dict(slam.iters_run)
    exp = expected_launches("hash", slam.sc.mlp_variant,
                            slam.mc.adam_state_dtype, 0, it)
    if launches != exp:
        raise AssertionError(f"overlap_hash: launches {launches} != "
                             f"expected {exp}")
    if pending["ba"] == 0 or pending["ba_landed"] != 1:
        raise AssertionError(f"overlap_hash: BA poses pending / landed "
                             f"{pending}")
    st = slam.stats
    track_ms = [f["phases"]["tracking"] * 1e3 for f in st.frames
                if "tracking" in f["phases"]]
    rep = {"frames": slam.n_img, "iters_run": it, "launches": launches,
           "mapping_cnt": slam.mapping_cnt, "pending": pending,
           "tracked_frame_ms_mean": float(np.mean(track_ms)),
           "drive_wall_s": wall, "est_c2w": slam.est_c2w.copy(),
           "gt_c2w": slam.gt_c2w.copy()}
    slam.close()
    return rep


def parallel_phase(setups, frame_list, trajs, device, out_dir) -> dict:
    """The multi-device drives: NCCL on one rank (8 frames), `dp_hash`
    (16 frames), `dp_brick` and `dp_brick_rows` (20) on two gloo ranks of
    this card, `overlap_hash` in this process (40), and `overlap_dp_hash`
    on three gloo ranks (40); sequential 8-, 20- and 40-frame runs as
    their references. `trajs[name]` = (gt_c2w, est_c2w) of the 200-frame
    drives."""
    import copy
    import shutil

    import numpy as np
    import torch
    from unislam_tpu_torch.config import update_recursive
    from unislam_tpu_torch.tools.eval_ate import pose_evaluation

    frames40 = frame_list[:DP_FRAMES]
    frames_dir = write_rank_frames(
        frames40, os.path.join(REPO, "build", "dp_frames"))
    res = {"frames": DP_FRAMES, "dp_hash_frames": DP_HASH_FRAMES,
           "brick_frames": DP_BRICK_FRAMES,
           "world": 2, "overlap_world": OVERLAP_WORLD, "backend": "gloo"}
    try:
        # sequential references on the same 40 frames
        seq = {}
        for name, n in (("hash", DP_FRAMES), ("brick_lowp",
                                               DP_BRICK_FRAMES)):
            slam, frames, launches, ate, wall_s = drive(
                setups[name][0], frames40[:n], device)
            seq[name] = {"est_c2w": slam.est_c2w.copy(),
                         "gt_c2w": slam.gt_c2w.copy(),
                         "ate_cm": ate["error.rmse"],
                         "mapping_cnt": slam.mapping_cnt,
                         "iters_run": dict(slam.iters_run),
                         "launches": launches,
                         "tracked_frame_ms_mean": float(np.mean(
                             [f["phases_ms"]["tracking"] for f in frames
                              if "tracking" in f["phases_ms"]])),
                         "mapping_phase_ms_mean": float(np.mean(
                             [f["phases_ms"]["mapping"] for f in frames
                              if "mapping" in f["phases_ms"]]))}
            del slam
            torch.cuda.empty_cache()
        res["sequential_40"] = {k: {x: y for x, y in v.items()
                                    if not x.endswith("c2w")}
                                for k, v in seq.items()}
        gt40 = seq["hash"]["gt_c2w"]
        hash_gt, hash_est = trajs["hash"]

        def ate(gt, est, n):
            return pose_evaluation(gt[:n], est[:n])[1]["error.rmse"]
        ref200 = ate(hash_gt, hash_est, DP_FRAMES)

        def dp_cfg(name, extra):
            cfg = copy.deepcopy(setups[name][0])
            update_recursive(cfg, {"parallel": {"data_parallel": True,
                                                **extra}})
            return cfg

        # NCCL, one rank: the backend a rank-per-card run takes. Every
        # collective of one rank is the identity, so it must be the
        # sequential run on the same frames bit for bit.
        # (on the f32 frames the ranks read)
        slam, _, launches, _, _ = drive(
            setups["hash"][0], [tuple(np.asarray(x, np.float32) for x in f)
                                for f in frames40[:NCCL_FRAMES]], device)
        seq8 = slam.est_c2w.copy()
        res["sequential_8"] = {"launches": launches}
        del slam
        cfg = dp_cfg("hash", {})
        reps = run_ranks("nccl_world1", cfg, frames_dir, 1, "nccl",
                         NCCL_FRAMES, out_dir)
        chk = check_ranks("nccl_world1", cfg, reps)
        chk.pop("scene_checksum")
        est = chk.pop("est_c2w")
        chk["bitwise_sequential_8"] = bool(np.array_equal(est, seq8))
        frame_cm = np.linalg.norm(est[:, :3, 3] - hash_est[:NCCL_FRAMES,
                                                           :3, 3], axis=1)
        chk["max_frame_diff_cm_vs_hash"] = float(frame_cm.max() * 100)
        if not chk["bitwise_sequential_8"]:
            raise AssertionError(f"nccl_world1: not bit for bit the "
                                 f"sequential run on its frames: {chk}")
        res["nccl_world1"] = chk
        print("parallel nccl_world1 " + json.dumps(
            {k: v for k, v in chk.items() if k != "ranks"}), flush=True)

        kept = {}   # name: (trajectory, final scene's checksums)
        for name, base, extra, rows, ref in (
                ("dp_hash", "hash", {}, None, None),
                ("dp_brick", "brick_lowp", {}, None, "brick_lowp"),
                ("dp_brick_rows", "brick_lowp", {"shard_tables": True},
                 True, "brick_lowp")):
            cfg = dp_cfg(base, extra)
            expect_rows = None
            if rows:
                from unislam_tpu_torch.models import scene as scene_lib
                spec = scene_lib.make_scene_config(cfg).brick_spec
                n = spec.total_rows
                expect_rows = {"table": -(-n // 2)}
            t0 = time.perf_counter()
            n = DP_HASH_FRAMES if ref is None else DP_BRICK_FRAMES
            reps = run_ranks(name, cfg, frames_dir, 2, "gloo", n, out_dir)
            chk = check_ranks(name, cfg, reps, expect_rows)
            chk["wall_s"] = time.perf_counter() - t0
            est = chk.pop("est_c2w")
            bits = chk.pop("scene_checksum")
            kept[name] = est, bits
            if ref is not None and not chk["ba_frames"]:
                # the bitwise pair must cover joint BA on the sharded path
                raise AssertionError(f"{name}: no phase ran joint BA in "
                                     f"{n} frames")
            if rows:
                # the same run as dp_brick but for the table's layout
                ref_est, ref_bits = kept["dp_brick"]
                same = {"trajectory": bool(np.array_equal(est, ref_est)),
                        "scene": bits == ref_bits}
                chk["bitwise_dp_brick"] = same
                if not all(same.values()):
                    raise AssertionError(f"{name}: not bit for bit "
                                         f"dp_brick: {same}")
            if ref is None:
                # the sequential hash drive's first frames
                chk["trajectory"] = trajectory_bands(
                    name, est, hash_gt, hash_est, ate(hash_gt, hash_est, n),
                    DP_ABS_CM)
                chk["vs_sequential"] = trajectory_bands(
                    name, est, gt40, seq["hash"]["est_c2w"],
                    ate(gt40, seq["hash"]["est_c2w"], n), held=False)
            else:
                # reported, not held: a change of summation order moves
                # the sequential brick_lowp run by several cm in these
                # frames (scripts/trajectory_sensitivity.py; PERF.md
                # section 6); dp_brick_rows is held to dp_brick instead
                chk["trajectory"] = trajectory_bands(
                    name, est, gt40, seq[ref]["est_c2w"],
                    seq[ref]["ate_cm"], held=False)
            res[name] = chk
            line = {"trajectory": chk["trajectory"], "wall_s": chk["wall_s"],
                    "ba_frames": chk["ba_frames"],
                    "ranks": [{k: r[k] for k in (
                        "rank", "iters_run", "launches",
                        "tracked_frame_ms_mean", "mapping_phase_ms_mean",
                        "mapping_phase_ms_steady", "allreduce_per_map_iter",
                        "allreduce_per_track_iter", "replica_checks")
                        if k in r} | {k: r[k] for k in (
                            "table_rows", "table_block_bytes",
                            "table_adam_state_bytes") if k in r}
                        | {"first_step_ok": r["first_step"]["ok"],
                           "k7_offset_bitwise": r["first_step"].get(
                               "k7_offset_bitwise")}
                        for r in chk["ranks"]]}
            if rows:
                line["bitwise_dp_brick"] = chk["bitwise_dp_brick"]
            print(f"parallel {name} " + json.dumps(line), flush=True)

        # tracking and mapping on one card, one stream
        ovl = overlap_drive(setups["hash"][0], frames40, device)
        ovl["trajectory"] = trajectory_bands(
            "overlap_hash", ovl.pop("est_c2w"), ovl.pop("gt_c2w"), hash_est,
            ref200, DP_ABS_CM, per_frame=False)
        if ovl["mapping_cnt"] != seq["hash"]["mapping_cnt"]:
            raise AssertionError(f"overlap_hash: {ovl['mapping_cnt']} "
                                 "mapping phases, sequential "
                                 f"{seq['hash']['mapping_cnt']}")
        ovl["sequential_tracked_frame_ms_mean"] = \
            seq["hash"]["tracked_frame_ms_mean"]
        res["overlap_hash"] = ovl
        print("parallel overlap_hash " + json.dumps(ovl), flush=True)

        # the overlapped driver over 3 ranks of this card: rank 0 tracks,
        # ranks 1-2 map data-parallel
        name = "overlap_dp_hash"
        cfg = copy.deepcopy(setups["hash"][0])
        t0 = time.perf_counter()
        reps = run_ranks(name, cfg, frames_dir, OVERLAP_WORLD, "gloo",
                         DP_FRAMES, out_dir, overlap=True)
        chk = check_overlap_ranks(name, cfg, reps)
        chk["wall_s"] = time.perf_counter() - t0
        est = chk.pop("est_c2w")
        chk["trajectory"] = trajectory_bands(
            name, est, hash_gt, hash_est, ref200, DP_ABS_CM, per_frame=False)
        chk["vs_sequential"] = trajectory_bands(
            name, est, gt40, seq["hash"]["est_c2w"], seq["hash"]["ate_cm"],
            held=False)
        # reported: the tracker tracks against a snapshot up to one phase
        # old, which moves the uncertainty trigger and with it the frames
        # that map (held above to the schedule, on every rank)
        chk["sequential"] = {k: seq["hash"][k] for k in ("mapping_cnt",
                                                         "iters_run")}
        res[name] = chk
        print(f"parallel {name} " + json.dumps(overlap_line(chk)),
              flush=True)
    finally:
        shutil.rmtree(frames_dir, ignore_errors=True)
    return res


def main() -> int:
    t_smoke = time.perf_counter()
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
    ptxas = {}   # each kernel's registers, shared memory and spills
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                ptxas.setdefault(name, []).append(line.strip())
                print(f"ptxas {name}: {line.strip()}")

    setups = {"hash": room0_setup(args.frames, "room0.yaml"),
              "hash_holes": room0_setup(args.frames, "room0.yaml"),
              "brick": room0_setup(args.frames, "room0_tpu.yaml"),
              "brick_lowp": room0_setup(args.frames, "room0_tpu.yaml",
                                        LOWP),
              "brick_dedup": room0_setup(args.frames, "room0_tpu.yaml",
                                         DEDUP),
              "brick_holes": room0_setup(args.frames, "room0_tpu.yaml")}
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
    for kname, recs in check_inference_kernels(
            setups, device, 500_000, 10_000).items():
        kern[kname].extend(recs)
        for r in recs:
            print(f"kernel {kname} " + json.dumps(r), flush=True)
    torch.cuda.empty_cache()
    for kname, recs in {**check_k4(device),
                        **check_k7(table_shapes(setups), device)}.items():
        kern[kname] = recs
        for r in recs:
            print(f"kernel {kname} " + json.dumps(r), flush=True)
    torch.cuda.empty_cache()
    cfg, ds = setups["brick"]
    for kname, recs in check_k8(cfg, ds, device,
                                cfg["mapping"]["pixels"] + 200).items():
        kern.setdefault(kname, []).extend(recs)
        for r in recs:
            print(f"kernel {kname} " + json.dumps(r), flush=True)
    torch.cuda.empty_cache()
    cfg, ds = setups["hash"]
    for kname, recs in check_k3(cfg, ds, device, cfg["tracking"]["pixels"],
                                cfg["mapping"]["pixels"] + 200,
                                10_000).items():
        kern[kname] = recs
        for r in recs:
            print(f"kernel {kname} " + json.dumps(r), flush=True)
    torch.cuda.empty_cache()
    print(f"kernels: checked in {time.perf_counter() - t0:.1f} s", flush=True)

    # every drive runs on the same frames, rendered once up front: the
    # procedural render is host numpy work that would otherwise compete
    # with the driver for the interpreter
    t0 = time.perf_counter()
    ds = setups["hash"][1]
    frame_list = [ds[i] for i in range(args.frames)]
    print(f"render: {args.frames} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    drive_frames = {name: frame_list for name in setups}
    drive_frames["hash_holes"] = drive_frames["brick_holes"] = \
        with_holes(frame_list)
    drives, frames, prof, trajs = {}, {}, {}, {}
    for name, (cfg, _) in setups.items():
        drives[name], frames[name], p, slam = run_drive(
            name, cfg, drive_frames[name], device, args.out)
        trajs[name] = (slam.gt_c2w.copy(), slam.est_c2w.copy())
        prof.update(p)
        if name == "brick":
            build.reset_launches()
            mesh = mesh_and_render(slam, cfg, frame_list, device)
            print("mesh brick " + json.dumps(mesh), flush=True)
        del slam
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    par = parallel_phase(setups, frame_list, trajs, device, args.out)
    par["wall_s"] = time.perf_counter() - t0
    par["card"] = card
    print(f"parallel: {par['wall_s']:.1f} s", flush=True)
    # every kernel launch of the phase's loops: the ranks', the overlapped
    # driver's and the sequential references'
    par_launches = [r["launches"] for name in ("nccl_world1", "dp_hash",
                                               "dp_brick", "dp_brick_rows",
                                               "overlap_dp_hash")
                    for r in par[name]["ranks"]] \
        + [par["overlap_hash"]["launches"], par["sequential_8"]["launches"]] \
        + [v["launches"] for v in par["sequential_40"].values()]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cli = cli_drive(setups["hash"],
                    frame_list[:min(CLI_FRAMES, args.frames)],
                    args.out, card)
    print(f"cli: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"smoke: {time.perf_counter() - t_smoke:.1f} s", flush=True)

    line = []
    for name, (src, replaces) in KERNELS.items():
        recs = kern[name]
        head = next(r for r in recs if r["shape"].startswith(HEADLINE[name]))
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": sum(d["launches"].get(name, 0)
                                     for d in drives.values())
                     + (mesh["k5_launches"] + mesh["render_k5_launches"]
                        if name == "brick_encode_fwd" else 0)
                     + (mesh["render_k3_launches"]
                        if name == "composite_fwd" else 0)
                     + sum(r.get(name, 0) for r in cli["launches_run"])
                     + sum(r.get(name, 0) for r in par_launches),
                     "max_abs_err": max(r["max_abs_err"] for r in recs),
                     "ms": head["ms"], "plain_ms": head["plain_ms"],
                     "bound_ms": head["bound_ms"],
                     "bound_by": head["bound_by"],
                     "library_ms": head["library_ms"],
                     "shape": head["shape"]})
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "ptxas": ptxas, "kernels": kern,
                   "drives": drives,
                   "frames": frames, "profile": prof, "mesh_brick": mesh,
                   "cli": cli, "parallel": par}, f, indent=1)
    print("parallel " + json.dumps({
        name: {k: par[name][k] for k in ("trajectory", "wall_s")
               if k in par[name]}
        for name in ("dp_hash", "dp_brick", "dp_brick_rows", "overlap_hash",
                     "overlap_dp_hash")}
        | {"dp_brick_rows_bitwise_dp_brick":
           par["dp_brick_rows"]["bitwise_dp_brick"],
           "nccl_world1_bitwise_sequential":
           par["nccl_world1"]["bitwise_sequential_8"],
           "wall_s": par["wall_s"]}), flush=True)
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
