"""Tiny, deterministic mapping problem for the multi-process checks.

Counterpart of `unislam_tpu/parallel/sim.py`, at its toy sizes: the brick
encoding (3 levels, 4 features, 2^8 hashed rows, resolutions 4 to 32) with
the surface-LOD band (n_fine 6), 24x32 frames, 8 + 4 samples a ray, a bank
of two keyframes, joint BA. Its ray counts are the JAX problem's on the
8-device mesh of the JAX package's tests (240 + 64 mapping rays, 240
tracking rays), whatever the number of ranks, so that one rank and several
solve the same problem.

Everything is seeded, so every process builds the same inputs; a state
made by the JAX package (its parameters, bank and draws, as numpy arrays)
can replace the port's own (`state`), so that the tests hold the port to
the JAX package on the same numbers while the workers import no JAX.

Run as the multi-process worker (each rank a process; rank 0 writes the
JSON result):

    python -m unislam_tpu_torch.parallel.sim <port> <world> <rank> <modes>
        <out.json> [--draws state.npz] [--shard-tables] [--device cpu|cuda]
        [--backend gloo|nccl]

It runs on the rank's card unless given `--device cpu`. `<modes>` is a
comma-separated list of `step` (one mapping step; loss and per-leaf
checksums), `track` (one tracking frame of 2 iterations), `slam`
(`run_tiny_slam`, 6 frames: poses, mapping losses and the final scene's
bit-pattern checksums), `overlap` (`run_tiny_overlap`: the same loop under
the overlapped driver, rank 0 tracking and the others mapping; every
rank's report, gathered) and `replicas` (rank 1 perturbs one leaf and
`assert_replicas_agree` must raise on every rank). A step, slam or overlap
mode may carry `+shard` (row-sharded tables, as `--shard-tables` gives
every such mode) and a step or slam mode `+bf16` (bf16-state Adam for the
table, K7 with each block's offset; a step mode also checks that block
bitwise against the same rows of a whole-table step).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from unislam_tpu_torch import resolve_device
from unislam_tpu_torch.core import pose as pose_lib
from unislam_tpu_torch.core import rng
from unislam_tpu_torch.core.rays import Intrinsics, camera_ray_dirs
from unislam_tpu_torch.engine import keyframes as kf_lib
from unislam_tpu_torch.engine import mapper as mapper_lib
from unislam_tpu_torch.engine import tracker as tracker_lib
from unislam_tpu_torch.models import brick_encoding as be
from unislam_tpu_torch.models import hash_encoding as he
from unislam_tpu_torch.models import scene as scene_lib
from unislam_tpu_torch.parallel import distributed as pdist
from unislam_tpu_torch.parallel import sharding
from unislam_tpu_torch.render.renderer import RenderConfig

INTR = Intrinsics(H=24, W=32, fx=30.0, fy=30.0, cx=15.5, cy=11.5)
MAX_KF, BANK_SIZE = 4, 64
# the JAX problem's mesh size, which sets its ray counts
RAY_DEVICES = 8
RC = RenderConfig(n_stratified=8, n_importance=4, perturb=True, n_fine=6)


def tiny_scene_config(bound=None, truncation: float = 0.06) -> \
        scene_lib.SceneConfig:
    spec = dict(n_levels=4, log2_hashmap_size=8, base_resolution=4,
                desired_resolution=32)
    return scene_lib.SceneConfig(
        sdf_spec=he.make_spec(**spec), color_spec=he.make_spec(**spec),
        bound=np.asarray([[-1.5, 1.5]] * 3, np.float32)
        if bound is None else bound,
        truncation=truncation, encoding="brick",
        brick_spec=be.make_spec(n_levels=3, n_features=4,
                                log2_hashmap_size=8, base_resolution=4,
                                desired_resolution=32, matmul_max_rows=64))


class TinyProblem(NamedTuple):
    mapper: mapper_lib.Mapper
    scene: Dict[str, Any]        # the whole scene (full tables)
    poses: torch.Tensor          # (MAX_KF + 1, 7)
    batch: mapper_lib.MapBatch
    group: Optional[pdist.RayGroup]
    device: torch.device


def _unflatten(state: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """{"<prefix>/a/b": x} -> {"a": {"b": x}}."""
    out: Dict[str, Any] = {}
    for key, v in state.items():
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            d = out
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = v
    return out


def build_tiny_mapping_problem(group=None, n_rays_base: int = 240,
                               shard_tables: bool = False, device="cpu",
                               state: Optional[Dict[str, np.ndarray]] = None,
                               adam_state_dtype: str = "float32"
                               ) -> TinyProblem:
    """The toy mapping problem on `device`, its ray batch split over
    `group`. `state` (flat "params/...", "bank/..." arrays) replaces the
    port's own seeded parameters and bank."""
    device = torch.device(device)
    sc = tiny_scene_config()
    per = max(1, n_rays_base // RAY_DEVICES)
    mc = mapper_lib.MapperConfig(pixels=per * RAY_DEVICES, iters=1,
                                 extra_rays=RAY_DEVICES * 8,
                                 adam_state_dtype=adam_state_dtype)
    depth = torch.full((INTR.H, INTR.W), 1.0, device=device)
    color = torch.full((INTR.H, INTR.W, 3), 0.5, device=device)
    rays_d = camera_ray_dirs(INTR, device=device)
    if state is not None:
        params = scene_lib.params_from_jax(_unflatten(state, "params"),
                                           device=device)
        bank = kf_lib.bank_from_jax(_unflatten(state, "bank"), device=device)
    else:
        params = scene_lib.init_params(sc, rng.generator(0), device)
        bank = kf_lib.init_bank(MAX_KF, BANK_SIZE, device)
        eye = torch.eye(4, device=device)
        for i in range(2):
            kf_lib.add_keyframe(bank, depth, color, rays_d, eye, eye, i,
                                rng.generator(i, device))
    table_rows = {k: params[k].shape[0]
                  for k in sharding.sharded_keys(params, shard_tables)} \
        if group is not None else {}
    mapper = mapper_lib.Mapper(sc, RC, mc, INTR, MAX_KF, BANK_SIZE, device,
                               group, table_rows)
    probs = torch.zeros(MAX_KF + 1, device=device)
    probs[[0, 1, MAX_KF]] = 1 / 3
    pose_grad_mask = torch.zeros(MAX_KF + 1, 1, device=device)
    pose_grad_mask[[1, MAX_KF]] = 1.0   # BA moves kf 1 and the current frame
    batch = mapper_lib.MapBatch(bank, depth, color, rays_d, probs, probs,
                                pose_grad_mask, probe=False)
    poses = torch.tensor([1.0, 0, 0, 0, 0, 0, 0],
                         device=device).repeat(MAX_KF + 1, 1)
    return TinyProblem(mapper, params, poses, batch, group, device)


def clone_tree(tree):
    """A copy of every tensor of a nested dict."""
    return {k: (clone_tree(v) if isinstance(v, dict) else v.clone())
            for k, v in tree.items()}


class TinyStep(NamedTuple):
    scene: Dict[str, Any]        # the stepped scene, full tables
    poses: torch.Tensor          # the trained poses, grad on
    loss: float
    leaves: Dict[str, Any]       # the trained leaves (row blocks), grads on
    opt: Any


def run_tiny_step(p: TinyProblem, draws=None, seed: int = 3,
                  lr_scale: float = 1.0) -> TinyStep:
    """One mapping step (draws from `draws`, else from `seed`); the
    problem's scene is left as it was."""
    blocks, offsets = {}, {}
    for k, n_rows in p.mapper.table_rows.items():
        a, b = sharding.group_block(n_rows, p.group)
        blocks[k] = p.scene[k][a:b]
        offsets[k] = a * p.scene[k].shape[1]
    leaves, poses = mapper_lib.trainable(
        clone_tree({**p.scene, **blocks}), p.poses)
    opt = mapper_lib.make_optimizer(p.mapper.mc, leaves, poses, lr_scale,
                                    offsets)
    gen = None if draws is not None else rng.generator(
        rng.fold_in(seed, 0), p.device)
    loss = p.mapper.step(leaves, poses, opt, p.batch, gen, draws)
    scene = {k: (sharding.gather_rows(v, p.mapper.table_rows[k], p.group)
                 if k in p.mapper.table_rows else v)
             for k, v in mapper_lib.frozen(leaves).items()}
    return TinyStep(scene, poses, float(loss), leaves, opt)


def run_tiny_track_frame(p: TinyProblem, n_iters: int = 2, draws=None,
                         seed: int = 11):
    """One tracking frame of `n_iters` iterations from the identity pose
    against the problem's scene, its rays split like mapping's. `draws`:
    one dict a iteration. Returns (pose7 after, TrackState, the last
    iteration's depth-error median)."""
    per = max(1, 240 // RAY_DEVICES)
    tc = tracker_lib.TrackerConfig(pixels=per * RAY_DEVICES, iters=n_iters,
                                   ignore_edge_W=2, ignore_edge_H=2)
    tracker = tracker_lib.Tracker(p.mapper.sc, RC, tc, INTR, p.device,
                                  p.group)
    pose = tracker_lib.make_pose(torch.tensor([1.0, 0, 0, 0, 0, 0, 0],
                                              device=p.device))
    opt = tracker_lib.make_optimizer(tc, pose)
    state = tracker.track_frame(p.scene, pose, opt, p.batch.cur_depth,
                                p.batch.cur_color, seed, n_iters,
                                draws=draws)
    return torch.cat([pose["R"], pose["T"]]).detach(), state, \
        float(tracker.last_median)


def param_checksums(tree, prefix: str = "") -> Dict[str, float]:
    """Sum of |x| (float64) per leaf, named by the JAX key path
    (`['scene']['table']`): a fingerprint of a step, comparable across
    process counts and with the JAX package's `param_checksums`."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out.update(param_checksums(v, name))
        else:
            out[name] = float(v.detach().double().abs().sum())
    return out


def tiny_slam_config(n_frames: int, data_parallel: bool,
                     shard_tables: bool = False,
                     adam_state_dtype: str = "float32"):
    """The config and frames of `run_tiny_slam`: the toy scene's sizes on
    the procedural room's 24x32 frames."""
    from unislam_tpu_torch.data.synthetic import SyntheticRoom, make_config

    ds = SyntheticRoom(n_frames=n_frames, intr=INTR, deg_per_frame=1.5)
    cfg = make_config(ds, {
        "grid": {"encoding": "brick", "brick_levels": 3, "brick_features": 4,
                 "brick_hash_size": 8, "brick_base_res": 4,
                 "brick_matmul_rows": 64, "voxel_sdf": 0.1},
        "rendering": {"n_stratified": 8, "n_importance": 4, "n_fine": 6},
        "model": {"truncation": 0.08},
        "tracking": {"pixels": 240, "iters": 4, "lr_T": 0.01, "lr_R": 0.004,
                     "ignore_edge_W": 3, "ignore_edge_H": 3},
        "mapping": {"pixels": 240, "iters": 2, "iters_first": 4,
                    "every_frame": 2, "keyframe_every": 2,
                    "adam_state_dtype": adam_state_dtype},
        "parallel": {"data_parallel": data_parallel,
                     "shard_tables": shard_tables},
        "data": {"prefetch": False}})
    return cfg, ds


def run_tiny_slam(group=None, n_frames: int = 6, device="cpu",
                  shard_tables: bool = False,
                  adam_state_dtype: str = "float32", scene_bits=None):
    """The SLAM loop (`UniSLAM.step_frame`: tracking, selection, mapping,
    keyframes) on the toy scene; with `group` given, data-parallel over
    the process group (which `UniSLAM` finds itself). Returns (est pose7
    (n, 7) numpy, mapping losses). A dict `scene_bits` receives each leaf
    of the final scene (full tables) as its bit-pattern checksum."""
    from unislam_tpu_torch.engine.slam import UniSLAM

    cfg, ds = tiny_slam_config(n_frames, group is not None, shard_tables,
                               adam_state_dtype)
    slam = UniSLAM(cfg, ds, seed=0, device=device)
    losses = []
    slam.on_mapping_done = lambda s, idx: losses.append(s.last_map_loss)
    for idx in range(n_frames):
        slam.step_frame(idx)
    slam.close()
    if scene_bits is not None:
        scene_bits.update({p: sharding.checksum(t).tolist()
                           for p, t in sharding.tensor_leaves(slam.params)})
    est7 = pose_lib.matrix_to_cam_pose(torch.as_tensor(slam.est_c2w))
    return est7.numpy(), losses


def run_tiny_overlap(n_frames: int = 11, device="cpu",
                     shard_tables: bool = False) -> Dict[str, Any]:
    """`run_tiny_slam`'s loop under `DistributedOverlappedSLAM` on every
    rank of the process group (rank 0 tracks, the others map); the
    mapping ranks' replicas are compared after every phase. At 11 frames
    the last phase has 5 keyframes, so it runs joint BA and its reply
    carries a BA pose, which the final `sync()` lands. Returns this rank's
    report: its role, the trajectory (est pose7) after the final
    `sync()`, the frames whose pose that sync moved, the seeds drawn, the
    mapping losses (mapping ranks), the counts, and the bit-pattern
    checksums of its scene (the tracking rank's: its last snapshot), plus,
    on the tracking rank, each frame's snapshot phase and age."""
    from unislam_tpu_torch.engine.overlap import DistributedOverlappedSLAM

    cfg, ds = tiny_slam_config(n_frames, False, shard_tables)
    cfg["parallel"]["overlap"] = True
    slam = DistributedOverlappedSLAM(cfg, ds, seed=0, device=device)
    losses, replicas = [], []

    def after_mapping(s, idx):
        if s.role == "map":
            losses.append(float(s._pending_loss))
            replicas.append(sharding.assert_replicas_agree(
                s.replica_state(), s.group, f"frame {idx}"))
    slam.on_mapping_done = after_mapping
    for idx in range(n_frames):
        slam.step_frame(idx)
    before = slam.est_c2w.copy()
    slam.sync()
    slam.close()
    est7 = pose_lib.matrix_to_cam_pose(torch.as_tensor(slam.est_c2w))
    rep = {"rank": slam.groups.rank, "role": slam.role,
           "est7": est7.tolist(), "losses": losses,
           "landed_by_sync": np.nonzero((before != slam.est_c2w).any(
               axis=(1, 2)))[0].tolist(),
           "seeds_drawn": slam.seeds._n,
           "mapping_cnt": slam.mapping_cnt, "kf_count": slam.kf_count,
           "iters_run": dict(slam.iters_run), "replica_checks": replicas,
           "map_ranks": 1 if slam.group is None else slam.group.size,
           "table_rows": {k: list(sharding.group_block(n, slam.group))
                          for k, n in slam.table_rows.items()},
           "scene_bits": {p: sharding.checksum(t).tolist()
                          for p, t in sharding.tensor_leaves(slam.params)}}
    if slam.role == "track":
        rep["snapshot_phase"] = slam.snapshot_phase.tolist()
        rep["snapshot_age"] = slam.snapshot_age.tolist()
    return rep


# ---------------------------------------------------------------------------
# the worker

def _k7_blocks_match(p: TinyProblem, step: TinyStep) -> bool:
    """Each row block's bf16-Adam step (K7, or its plain version on the
    CPU, with the block's offset) bitwise against the same rows of one
    step of the whole table on the same (summed) gradient."""
    from unislam_tpu_torch.core import optim

    ok = True
    for opt in step.opt.opts[1:]:
        for g in opt.param_groups:
            (blk,) = g["params"]
            key = next(k for k, v in step.leaves.items() if v is blk)
            n_rows = p.scene[key].shape[0]
            a, b = sharding.group_block(n_rows, p.group)
            g_full = sharding.gather_rows(blk.grad, n_rows, p.group)
            p0 = p.scene[key].clone()
            zeros = torch.zeros_like(p0, dtype=torch.bfloat16)
            s = optim.step_scalars(g["count"], 0, g["lr"], g["lr_scale"])
            if p0.is_cuda:
                m, v = zeros.clone(), zeros.clone()
                from unislam_tpu_torch.kernels import adam_lp as k7
                k7.adam_lp_step(p0, g_full, m, v, s)
            else:
                p0, m, v = optim.adam_lp_plain(p0, g_full, zeros, zeros, s)
            st = opt.state[blk]
            bits = lambda t: t.contiguous().view(  # noqa: E731
                torch.int16 if t.element_size() == 2 else torch.int32)
            ok &= all(torch.equal(bits(x[a:b]), bits(y)) for x, y in
                      ((p0, blk.detach()), (m, st["m"]), (v, st["v"])))
    return bool(ok)


def _load_state(path: Optional[str]) -> Optional[Dict[str, np.ndarray]]:
    if path is None:
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _draws(state, prefix: str, device):
    if state is None:
        return None
    d = _unflatten(state, prefix)
    conv = lambda x: torch.as_tensor(x).to(device)  # noqa: E731
    if prefix == "track":
        return [{k: conv(x) for k, x in d[str(i)].items()}
                for i in range(len(d))]
    return {k: conv(x) for k, x in d.items()}


def run_modes(modes, group, device, state=None,
              shard_tables=False) -> Dict[str, Any]:
    """Run each mode on this rank; returns {mode: result}."""
    out: Dict[str, Any] = {}
    for mode in modes:
        name, *opts = mode.split("+")
        shard = shard_tables or "shard" in opts
        dtype = "bfloat16" if "bf16" in opts else "float32"
        if name == "step":
            p = build_tiny_mapping_problem(group, shard_tables=shard,
                                           device=device, state=state,
                                           adam_state_dtype=dtype)
            st = run_tiny_step(p, _draws(state, "step", device))
            res = {"loss": st.loss, "checksums": param_checksums(
                {"scene": st.scene, "poses": st.poses}),
                "rows": {k: list(sharding.group_block(n, group))
                         for k, n in p.mapper.table_rows.items()}}
            if dtype == "bfloat16":
                res["k7_offset_bitwise"] = _k7_blocks_match(p, st)
            out[mode] = res
        elif name == "track":
            p = build_tiny_mapping_problem(group, device=device, state=state)
            pose7, ts, median = run_tiny_track_frame(
                p, draws=_draws(state, "track", device))
            out[mode] = {"pose7": pose7.tolist(), "median": median,
                         "best7": ts.best7.tolist(),
                         "min_loss": float(ts.min_loss),
                         "unc_prev": float(ts.unc_prev),
                         "unc_last": float(ts.unc_last)}
        elif name == "slam":
            bits = {}
            est7, losses = run_tiny_slam(group, device=device,
                                         shard_tables=shard,
                                         adam_state_dtype=dtype,
                                         scene_bits=bits)
            out[mode] = {"est7": est7.tolist(), "losses": losses,
                         "scene_bits": bits}
        elif name == "overlap":
            reports = [None] * torch.distributed.get_world_size()
            torch.distributed.all_gather_object(
                reports, run_tiny_overlap(device=device, shard_tables=shard))
            out[mode] = reports
        elif name == "replicas":
            p = build_tiny_mapping_problem(group, device=device, state=state)
            tree = {"scene": p.scene, "bank": p.batch.bank}
            agree = sharding.assert_replicas_agree(tree, group)
            if group is not None and group.rank == 1:
                p.scene["sdf_mlp"]["w0"][0, 0] += 1e-6
            try:
                sharding.assert_replicas_agree(tree, group)
                raised = False
            except AssertionError:
                raised = True
            out[mode] = {"compared": agree, "raised_after_perturb": raised}
        else:
            raise ValueError(f"unknown mode {mode!r}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("port", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("modes")
    ap.add_argument("out")
    ap.add_argument("--draws", default=None,
                    help="a state .npz (params/, bank/, step/, track/)")
    ap.add_argument("--shard-tables", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the rank's card unless given (cpu to run there)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    device = resolve_device(args.device)
    rank = pdist.initialize_from_env(f"localhost:{args.port}", args.world,
                                     args.rank, backend=args.backend,
                                     device=device)
    if device.type == "cuda":
        device = pdist.rank_device()
    group = pdist.global_ray_group()
    out = run_modes(args.modes.split(","), group, device,
                    _load_state(args.draws), args.shard_tables)
    if rank == 0:
        with open(args.out, "w") as f:
            json.dump({"world": args.world, **out}, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"rank {rank} done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
