#!/usr/bin/env python3
"""One rank of a data-parallel SLAM run over frames held in files, with the
checks of `chip_smoke.py`'s multi-device drives.

    python3 scripts/smoke_rank.py <port> <world> <rank>
        <config.json> <frames_dir> <out_dir> [--n-frames N]
        [--device cuda|cpu] [--backend gloo|nccl] [--timeout S] [--overlap]

`config.json` is a merged config (with `parallel.data_parallel: true`);
`frames_dir` holds `color.npy` (N, H, W, 3), `depth.npy` (N, H, W) and
`pose.npy` (N, 4, 4), read memory-mapped. Each rank runs
`UniSLAM.step_frame` over the frames and writes `rank<r>.json` into
`out_dir`:

- the first mapping iteration held against a one-rank step on the same
  whole-batch draws (`check_first_step`): the loss, and every leaf's
  gradient after the all-reduce (a row-sharded table: the rank's rows);
  with bf16-state Adam on row-sharded tables, K7 on the rank's block
  (with its offset) bitwise against the same rows of K7 stepping the
  whole table on the same gradient;
- `assert_replicas_agree` on `UniSLAM.replica_state()` after every
  mapping phase (a rank that differs raises, and so fails);
- the trajectory, the bit-pattern checksums of the final scene
  (`UniSLAM.params`, whose row-sharded tables are the gathered full
  tables), the seeds drawn, the frames whose phase ran joint BA, the
  iterations run and the kernel launches of the loop (the checks' own
  launches are left out);
- per-phase times, and the all-reduces of each phase (calls, bytes,
  seconds; the device is synchronised around each one, so the seconds are
  the collective's own and not the wait for the work queued before it).

With `--overlap` the ranks run `DistributedOverlappedSLAM` (world >= 2):
rank 0 tracks and reports its tracked-frame times, how long each
mapping frame's `sync()` waited, each tracked frame's snapshot phase and
age, and the checksum of its snapshot after the final `sync()`; ranks
1..N-1 map data-parallel over their own group and do the checks above
(the first step, the replicas after every phase), and rank 1 reports
each reply's bytes and the milliseconds from its start (the device
synchronised first) to its completion. Every rank reports its peak
device memory.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time
from collections import Counter
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from unislam_tpu_torch.engine import mapper as mapper_lib  # noqa: E402
from unislam_tpu_torch.kernels import build  # noqa: E402
from unislam_tpu_torch.models import brick_encoding  # noqa: E402
from unislam_tpu_torch.models import hash_encoding  # noqa: E402
from unislam_tpu_torch.parallel import distributed as pdist  # noqa: E402
from unislam_tpu_torch.parallel import sharding  # noqa: E402
from unislam_tpu_torch.parallel.sim import clone_tree  # noqa: E402
from unislam_tpu_torch.render import renderer  # noqa: E402

# the first step's tolerances against one rank on the same draws: the loss
# rtol 1e-5; a dense leaf's gradient rtol 1e-4 plus 1e-5 of its largest
# |element|; a table's within TABLE_TOL of each element's sum of |terms|
# plus 1e-5 of its largest (hash terms are f32 products, which round-off
# upstream moves by a few ulps; brick terms are bf16(bf16(w) * bf16(g)),
# which it can move by one bf16 step, 2^-8)
# The fused decoders' (K4) weight gradients are bf16 roundings of f32 sums
# (summed over the ranks before the rounding), which round-off in the sum
# can move by one bf16 step: held to 2^-7 of the value plus 1e-5 of the
# largest, as the tests hold K4's.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
TABLE_TOL = {"hash": 2.0 ** -16, "brick": 2.0 ** -7}
BF16_RTOL = 2.0 ** -7


class _Frames:
    """The frames of `frames_dir`, memory-mapped: (color, depth, c2w)."""

    def __init__(self, path: str, n: int):
        self.color = np.load(os.path.join(path, "color.npy"), mmap_mode="r")
        self.depth = np.load(os.path.join(path, "depth.npy"), mmap_mode="r")
        self.pose = np.load(os.path.join(path, "pose.npy"))
        self.n = min(n, len(self.pose))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.asarray(self.color[i]), np.asarray(self.depth[i]),
                self.pose[i])


def _record_terms(calls):
    """Wrap both encodings' scatter-accumulate so that each call also
    appends its sum of |terms| a destination (float64) to `calls`;
    returns the undo."""
    real = {m: m.scatter_accumulate for m in (hash_encoding, brick_encoding)}

    def make(fn):
        def spy(idx, rows, n_rows):
            acc = torch.zeros((n_rows,) + tuple(rows.shape[1:]),
                              dtype=torch.float64, device=rows.device)
            acc.index_add_(0, idx.long(), rows.abs().double())
            calls.append(acc)
            return fn(idx, rows, n_rows)
        return spy

    for m, fn in real.items():
        m.scatter_accumulate = make(fn)

    def undo():
        for m, fn in real.items():
            m.scatter_accumulate = fn
    return undo


def _misfit(got, ref, terms=None, coef=0.0) -> Dict[str, Any]:
    """Largest |got - ref| and its ratio to the tolerance (<= 1 passes)."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    big = float(ref.abs().max()) if ref.numel() else 0.0
    if terms is None:
        tol = GRAD_RTOL * ref.abs() + GRAD_ATOL_REL * big
    else:
        tol = coef * terms.reshape(ref.shape) + GRAD_ATOL_REL * big
    ratio = float((err / tol.clamp(min=1e-300)).max()) if err.numel() \
        else 0.0
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "worst_ratio_to_tol": ratio}


def check_first_step(slam) -> Dict[str, Any]:
    """Arrange for the first mapping iteration to be checked (see the
    module note); returns the dict its results land in."""
    mapper, report = slam.mapper, {}
    real_step = mapper.step

    def first_step(scene, poses, opt, batch, generator=None, draws=None):
        mapper.step = real_step
        before = Counter(build.LAUNCHES)
        dev = mapper.device
        # the whole batch's draws, in the order every rank draws them
        full = dict(mapper.draw(batch, generator))
        full.update(renderer.draw(mapper.rc, mapper.mc.pixels
                                  + mapper.mc.extra_rays, batch.probe,
                                  generator, dev))
        # one rank on the same draws and the whole scene
        one = mapper_lib.Mapper(mapper.sc, mapper.rc, mapper.mc,
                                mapper.intr, mapper.max_kf,
                                mapper.bank_size, dev)
        whole = {k: (sharding.gather_rows(v, slam.table_rows[k],
                                          slam.group)
                     if k in slam.table_rows else v)
                 for k, v in mapper_lib.frozen(scene).items()}
        ref_scene, ref_poses = mapper_lib.trainable(clone_tree(whole),
                                                    poses.detach())
        terms = []
        undo = _record_terms(terms)
        try:
            ref_loss = one.backward(ref_scene, ref_poses, batch, draws=full)
        finally:
            undo()
        abs_terms = {}
        for acc in terms:
            for k, v in ref_scene.items():
                if k in sharding.TABLE_KEYS and acc.numel() == v.numel():
                    abs_terms[k] = abs_terms.get(k, 0) + acc.view(v.shape)
        build.LAUNCHES.clear()
        build.LAUNCHES.update(before)

        # this rank's step: its rays, gradients summed over the ranks
        opt.zero_grad(set_to_none=True)
        loss = mapper.backward(scene, poses, batch, draws=full)
        coef = TABLE_TOL[mapper.sc.encoding]
        leaves = {"loss": {"got": float(loss), "ref": float(ref_loss),
                           "rel_err": abs(float(loss) - float(ref_loss))
                           / abs(float(ref_loss))}}
        ok = leaves["loss"]["rel_err"] <= LOSS_RTOL
        for k, v in scene.items():
            subs = v.items() if isinstance(v, dict) else [("", v)]
            for sub, t in subs:
                ref_t = ref_scene[k][sub] if sub else ref_scene[k]
                g_ref = ref_t.grad
                if k in slam.table_rows:
                    a, b = sharding.group_block(slam.table_rows[k],
                                                slam.group)
                    g_ref = g_ref[a:b]
                    tt = abs_terms[k][a:b]
                else:
                    tt = abs_terms.get(k)
                if mapper.sc.mlp_variant == "fused" and sub:
                    tt, c = g_ref.abs(), BF16_RTOL
                else:
                    c = coef
                m = _misfit(t.grad, g_ref, tt, c)
                leaves[f"{k}/{sub}" if sub else k] = m
                ok &= m["worst_ratio_to_tol"] <= 1.0
        m = _misfit(poses.grad, ref_poses.grad)
        leaves["poses"] = m
        ok &= m["worst_ratio_to_tol"] <= 1.0
        # K7 on the rank's block against K7 on the whole table
        k7 = _k7_whole_table_reference(slam, scene, opt)
        opt.step()
        report.update(leaves=leaves, tolerance={
            "loss_rtol": LOSS_RTOL, "grad_rtol": GRAD_RTOL,
            "grad_atol_of_largest": GRAD_ATOL_REL,
            "fused_weight_rtol": BF16_RTOL,
            "table_of_abs_terms": coef})
        if k7 is not None:
            before = Counter(build.LAUNCHES)
            report["k7_offset_bitwise"] = k7()
            build.LAUNCHES.clear()
            build.LAUNCHES.update(before)
            ok &= report["k7_offset_bitwise"]
        report["ok"] = bool(ok)
        return loss

    mapper.step = first_step
    return report


def _k7_whole_table_reference(slam, scene, opt):
    """For bf16-state Adam on row-sharded tables: a function that, called
    after the step, steps each whole table with K7 (or its plain version)
    on the same summed gradient and compares the rank's rows bitwise."""
    if not slam.table_rows or not hasattr(opt, "opts"):
        return None
    from unislam_tpu_torch.core import optim

    lp = opt.opts[-1]
    cases = []
    for g in lp.param_groups:
        (blk,) = g["params"]
        key = next(k for k, v in scene.items() if v is blk)
        n_rows = slam.table_rows[key]
        cases.append((g, blk, key, slam.params[key].clone(),
                      sharding.gather_rows(blk.grad, n_rows, slam.group),
                      sharding.group_block(n_rows, slam.group)))

    def compare() -> bool:
        ok = True
        bits = lambda t: t.contiguous().view(  # noqa: E731
            torch.int16 if t.element_size() == 2 else torch.int32)
        for g, blk, key, p0, g_full, (a, b) in cases:
            s = optim.step_scalars(g["count"], 0, g["lr"], g["lr_scale"])
            m = torch.zeros_like(p0, dtype=torch.bfloat16)
            v = torch.zeros_like(m)
            if p0.is_cuda:
                from unislam_tpu_torch.kernels import adam_lp as k7
                k7.adam_lp_step(p0, g_full, m, v, s)
            else:
                p0, m, v = optim.adam_lp_plain(p0, g_full, m, v, s)
            st = lp.state[blk]
            ok &= all(torch.equal(bits(x[a:b]), bits(y)) for x, y in
                      ((p0, blk.detach()), (m, st["m"]), (v, st["v"])))
        return bool(ok)
    return compare


def time_collectives(slam) -> Dict[str, Counter]:
    """Count and time the all-reduces that `track_frame` and `map_frame`
    make ({phase: {"calls", "bytes", "s"}}): `torch.distributed.all_reduce`
    is wrapped for this process, and the device synchronised before and
    after each call made inside one of those phases."""
    comm = {"tracking": Counter(), "mapping": Counter()}
    phase = [None]
    real = dist.all_reduce

    def all_reduce(t, *a, **kw):
        if phase[0] is None:
            return real(t, *a, **kw)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = real(t, *a, **kw)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        c = comm[phase[0]]
        c["s"] += time.perf_counter() - t0
        c["calls"] += 1
        c["bytes"] += t.numel() * t.element_size()
        return out

    def in_phase(fn, name):
        def wrapped(*a, **kw):
            phase[0] = name
            try:
                return fn(*a, **kw)
            finally:
                phase[0] = None
        return wrapped

    dist.all_reduce = all_reduce
    slam.track_frame = in_phase(slam.track_frame, "tracking")
    slam.map_frame = in_phase(slam.map_frame, "mapping")
    return comm


def time_replies(slam) -> list:
    """Rank 1 of an overlapped run: each mapping phase's reply to the
    tracking rank, its bytes and the ms from its start (after the device
    finished the phase) to its completion, which a callback on the
    transfer's future records."""
    sends = []
    real = slam._send_reply

    def send(idx):
        if slam.device.type == "cuda":
            torch.cuda.synchronize(slam.device)
        t0 = time.perf_counter()
        real(idx)
        rec = {"idx": idx, "bytes": int(slam._send_buf.numel())}
        sends.append(rec)
        slam._send.get_future().then(lambda _: rec.__setitem__(
            "ms", (time.perf_counter() - t0) * 1e3))
    slam._send_reply = send
    return sends


def run(slam, timeout_s: float = 1e9) -> Dict[str, Any]:
    """Every frame through `step_frame`, the replicas compared after each
    mapping phase; returns the rank's report."""
    group = slam.group
    role = getattr(slam, "role", "map")   # an overlapped run's role
    first = check_first_step(slam) if role == "map" else None
    comm = time_collectives(slam)
    replies = time_replies(slam) if getattr(slam, "groups", None) \
        and slam.groups.rank == 1 else None
    replica_checks = []
    # the mapped frames whose phase ran joint BA (the tracking rank of an
    # overlapped run maps none)
    ba_frames = []
    writeback = slam._writeback_ba_pose

    def count_ba(idx, pose7):
        ba_frames.append(idx)
        writeback(idx, pose7)
    slam._writeback_ba_pose = count_ba

    def after_mapping(s, idx):
        if role != "map":
            return
        before = Counter(build.LAUNCHES)
        n = sharding.assert_replicas_agree(s.replica_state(), group,
                                           f"frame {idx}")
        build.LAUNCHES.clear()
        build.LAUNCHES.update(before)
        replica_checks.append({"idx": idx, "tensors": n})

    slam.on_mapping_done = after_mapping
    build.reset_launches()
    t0 = time.perf_counter()
    for idx in range(slam.n_img):
        slam.step_frame(idx)
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError(f"rank {slam.rank}: frame {idx} after "
                               f"{timeout_s} s")
    getattr(slam, "sync", lambda: None)()   # an overlapped run's last reply
    if slam.device.type == "cuda":
        torch.cuda.synchronize(slam.device)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    st = slam.stats
    it = dict(slam.iters_run)
    track_ms = [f["phases"]["tracking"] * 1e3 for f in st.frames
                if "tracking" in f["phases"]]
    map_ms = [f["phases"]["mapping"] * 1e3 for f in st.frames
              if "mapping" in f["phases"]]
    rep = {
        "rank": slam.rank, "world": 1 if group is None else group.size,
        "device": str(slam.device),
        "device_name": torch.cuda.get_device_name(slam.device)
        if slam.device.type == "cuda" else "cpu",
        "frames": slam.n_img, "iters_run": it, "launches": launches,
        "mapping_cnt": slam.mapping_cnt, "kf_count": slam.kf_count,
        "mapped_frames": [f["idx"] for f in st.frames if f["mapped"]],
        "frame_iters": [f["t_iters"] for f in st.frames],
        "est_c2w": slam.est_c2w.tolist(), "drive_wall_s": wall,
        # every leaf's bit patterns (an overlapped tracker's: its
        # snapshot after the final sync)
        "scene_checksum": {p: sharding.checksum(t).tolist()
                           for p, t in sharding.tensor_leaves(slam.params)},
        "seeds_drawn": slam.seeds._n,
        "ba_frames": ba_frames,
        "tracked_frame_ms_mean": float(np.mean(track_ms)),
        "tracked_frame_ms_steady": float(np.mean(track_ms[1:]))
        if len(track_ms) > 1 else float(track_ms[0]),
        "mapping_phase_ms_mean": float(np.mean(map_ms)),
        "mapping_phase_ms_steady": float(np.mean(map_ms[1:]))
        if len(map_ms) > 1 else float(map_ms[0]),
        "comm": {ph: dict(c) for ph, c in comm.items()},
        "allreduce_per_map_iter": {
            "ms": comm["mapping"]["s"] * 1e3 / max(it["map"], 1),
            "bytes": comm["mapping"]["bytes"] / max(it["map"], 1),
            "calls": comm["mapping"]["calls"] / max(it["map"], 1)},
        "allreduce_per_track_iter": {
            "ms": comm["tracking"]["s"] * 1e3 / max(it["track"], 1),
            "bytes": comm["tracking"]["bytes"] / max(it["track"], 1),
            "calls": comm["tracking"]["calls"] / max(it["track"], 1)},
        "replica_checks": len(replica_checks),
        "first_step": first,
        "role": role,
        "peak_device_bytes": {
            "allocated": torch.cuda.max_memory_allocated(slam.device),
            "reserved": torch.cuda.max_memory_reserved(slam.device)}
        if slam.device.type == "cuda" else None,
        "table_rows": {k: {"rows": list(sharding.group_block(n, group)),
                           "of": n, "row_bytes":
                           slam.params[k][0].numel() * 4}
                       for k, n in slam.table_rows.items()},
    }
    if hasattr(slam, "groups"):
        rep["global_rank"] = slam.groups.rank
        rep["map_ranks"] = slam.groups.world - 1
        rep["sync_wait_ms"] = map_ms if role == "track" else None
        if role == "track":
            # the tracker's "mapping" phase is its wait for the last reply
            rep.pop("mapping_phase_ms_mean")
            rep.pop("mapping_phase_ms_steady")
            tracked = slam.snapshot_phase >= 0
            rep["snapshot_phase"] = slam.snapshot_phase.tolist()
            rep["snapshot_age"] = slam.snapshot_age.tolist()
            rep["snapshot_ages"] = {
                str(a): int(n) for a, n in zip(*np.unique(
                    slam.snapshot_age[tracked], return_counts=True))}
        else:
            # a mapping rank's "tracking" phase is its wait for the record
            rep["record_wait_ms_mean"] = rep.pop("tracked_frame_ms_mean")
            rep.pop("tracked_frame_ms_steady")
        if replies is not None:
            rep["replies"] = replies
    if slam.table_rows and slam.map_opt is not None:
        opt, blocks = slam.map_opt
        state = [t for o in getattr(opt, "opts", (opt,))
                 for p in o.param_groups for q in p["params"]
                 if id(q) in blocks for t in o.state.get(q, {}).values()
                 if isinstance(t, torch.Tensor)]
        rep["table_block_bytes"] = sum(
            (b - a) * r["row_bytes"] for r in rep["table_rows"].values()
            for a, b in [r["rows"]])
        rep["table_adam_state_bytes"] = sum(t.numel() * t.element_size()
                                            for t in state)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("port", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("config")
    ap.add_argument("frames")
    ap.add_argument("out")
    ap.add_argument("--n-frames", type=int, default=10 ** 9)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--overlap", action="store_true",
                    help="the overlapped driver: rank 0 tracks, the others "
                         "map")
    args = ap.parse_args(argv)

    from unislam_tpu_torch.engine.overlap import DistributedOverlappedSLAM
    from unislam_tpu_torch.engine.slam import UniSLAM

    device = torch.device(args.device)
    pdist.initialize_from_env(
        f"localhost:{args.port}", args.world, args.rank,
        backend=args.backend, device=device,
        timeout=datetime.timedelta(seconds=args.timeout))
    with open(args.config) as f:
        cfg = json.load(f)
    cfg.setdefault("parallel", {})["data_parallel"] = not args.overlap
    cfg["parallel"]["overlap"] = args.overlap
    cfg.setdefault("profiling", {})["enabled"] = True
    cfg.setdefault("data", {})["prefetch"] = False
    frames = _Frames(args.frames, args.n_frames)
    driver = DistributedOverlappedSLAM if args.overlap else UniSLAM
    slam = driver(cfg, frames, seed=0, device=args.device)
    rep = run(slam, args.timeout)
    slam.close()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(rep, f)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {args.rank} done: {rep['iters_run']}", flush=True)
    first = rep["first_step"]
    return 0 if first is None or first.get("ok", False) else 3


if __name__ == "__main__":
    sys.exit(main())
