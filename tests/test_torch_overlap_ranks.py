"""The overlapped driver with a ray-sharded mapping side
(`unislam_tpu_torch.engine.overlap.DistributedOverlappedSLAM`) on the CPU,
as real gloo processes: rank 0 tracks, ranks 1..N-1 map data-parallel over
their own group.

- The toy SLAM loop of `parallel/sim.py` (11 frames, the last phase with
  joint BA) on 3 ranks, with and without row-sharded tables, and on 2
  (`python -m unislam_tpu_torch.parallel.sim ... overlap`): every rank
  ends on one trajectory, with the last phase's BA pose landed by the
  final sync, and drew as many seeds; the mapping replicas agree after
  every phase, the tracker's last snapshot is the mapping scene bit for
  bit, no tracked frame used a snapshot older than the previous mapping
  phase, and the mapping and keyframe counts are the sequential
  driver's.
- `scripts/smoke_rank.py --overlap` (the smoke's ranks) on `_small` (7
  frames of `tests/test_torch_overlap.py`) on 3 ranks and on the toy's 3
  frames on 2: the mapping group's first iteration against one rank on
  the same draws, to `check_first_step`'s tolerances; on `_small` the ATE
  against the JAX package's `OverlappedSLAM` with its 7-device mapping
  sub-mesh on 8 virtual CPU devices, as the conftest sets them up.
- The CLI on 3 ranks, then `--resume`: the writer (rank 1) alone writes.
- In process, `scripts/overlap_lag_witness.py`'s `LaggedSLAM` on the toy:
  each frame tracks the scene of the phase before the last, bit for bit.

The snapshot a frame tracks against depends on when a transfer ends, so
an overlapped run is not bit for bit repeatable and its ATE is held to a
band. One seed's 7-frame ATE is one draw: the JAX package's overlapped
driver read 0.61, 4.37, 3.29 and 1.77 cm on seeds 0-3, so the band is 1 cm
around its median over those seeds, which `scripts/overlap_jax_witness.py`
measures anew beside the port's ranks (four processes at once).
Each worker runs one intra-op thread; a worker that hangs is killed when
its launch's time runs out, and the test fails.
"""

import json
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_overlap import _small
from test_torch_runtime import _room_cfg, _write_room
from unislam_tpu_torch.engine import overlap
from unislam_tpu_torch.parallel import distributed as tdist
from unislam_tpu_torch.parallel import sharding
from unislam_tpu_torch.parallel import sim as tsim
from unislam_tpu_torch.tools.eval_ate import evaluate_ate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's seeds of OverlappedSLAM on `_small`, 7 frames
JAX_SEEDS = "0,1,2,3"
ATE_BAND_CM, ATE_ABS_CM = 1.0, 5.0
TOY_RUNS = ("3", "3+shard", "2")
TOY_FRAMES = 11   # `run_tiny_overlap`'s


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(cmds, envs=None):
    """Start each command as a worker of one intra-op thread."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(c, cwd=REPO, env={**env, **(e or {})},
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
            for c, e in zip(cmds, envs or [None] * len(cmds))]


def _finish(procs, timeout: float):
    """Each worker's output; every worker is killed once `timeout`
    seconds have passed, and a worker that failed fails the test."""
    outs, end = [], time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, end - time.monotonic()))[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"
    return outs


def _sim(world: int, modes: str, out: str):
    port = _free_port()
    return [[sys.executable, "-m", "unislam_tpu_torch.parallel.sim",
             str(port), str(world), str(r), modes, out, "--device", "cpu"]
            for r in range(world)]


def _ranks(world: int, run_dir, cfg, frames):
    """`scripts/smoke_rank.py --overlap` commands on `frames` (written to
    `run_dir` with the config)."""
    os.makedirs(run_dir, exist_ok=True)
    for i, key in enumerate(("color", "depth", "pose")):
        np.save(os.path.join(run_dir, f"{key}.npy"),
                np.stack([f[i] for f in frames]).astype(np.float32))
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(cfg, f, default=np.ndarray.tolist)
    port = _free_port()
    return [[sys.executable, os.path.join(REPO, "scripts", "smoke_rank.py"),
             str(port), str(world), str(r),
             os.path.join(run_dir, "config.json"), str(run_dir),
             os.path.join(run_dir, "out"), "--device", "cpu", "--backend",
             "gloo", "--timeout", "200", "--overlap"]
            for r in range(world)]


def _reports(run_dir, world: int):
    return [json.load(open(os.path.join(run_dir, "out", f"rank{r}.json")))
            for r in range(world)]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy loop on 3 ranks (with and without row-sharded tables) and
    on 2, the toy's 3 frames as 2 smoke ranks, all at once; and the
    sequential driver's counts, in this process."""
    tmp = tmp_path_factory.mktemp("toy")
    cfg, ds = tsim.tiny_slam_config(3, False)
    procs = _start(_sim(3, "overlap,overlap+shard", str(tmp / "3.json"))
                   + _sim(2, "overlap", str(tmp / "2.json"))
                   + _ranks(2, tmp / "ranks2", cfg,
                            [ds[i] for i in range(3)]))
    from unislam_tpu_torch.engine.slam import UniSLAM
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, ds = tsim.tiny_slam_config(TOY_FRAMES, False)
        seq = UniSLAM(cfg, ds, seed=0, device="cpu")
        for i in range(TOY_FRAMES):
            seq.step_frame(i)
        seq.close()
    finally:
        torch.set_num_threads(threads)
    _finish(procs, 240)
    three = json.load(open(tmp / "3.json"))
    two = json.load(open(tmp / "2.json"))
    return {"runs": {"3": three["overlap"], "3+shard": three["overlap+shard"],
                     "2": two["overlap"]},
            "ranks2": _reports(tmp / "ranks2", 2),
            "sequential": (seq.mapping_cnt, seq.kf_count)}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """`_small` as 3 smoke ranks, and meanwhile the JAX package's
    OverlappedSLAM on the same frames over seeds 0-3, a process a seed
    (`scripts/overlap_jax_witness.py --jobs 4`)."""
    run_dir = tmp_path_factory.mktemp("small")
    ds, cfg = _small(n_frames=7)
    witness = [sys.executable, os.path.join(REPO, "scripts",
                                            "overlap_jax_witness.py"),
               "--seeds", JAX_SEEDS, "--jobs", "4"]
    outs = _finish(_start(_ranks(3, run_dir, cfg, [ds[i] for i in range(7)])
                          + [witness]), 420)
    jax_runs = [json.loads(line) for line in outs[-1].splitlines()
                if line.startswith('{"seed"')]
    return {"ranks": _reports(run_dir, 3), "gt": np.stack(
        [ds[i][2] for i in range(7)]), "jax": jax_runs, "outs": outs}


# ------------------------------------------------------------ in process

def test_overlap_groups_need_a_process_group():
    assert tdist.overlap_groups() is None
    ds, cfg = _small(n_frames=3)
    with pytest.raises(ValueError, match=">= 2 ranks"):
        overlap.DistributedOverlappedSLAM(cfg, ds, device="cpu")


def test_snapshot_packing_is_bitwise_and_aligned():
    """The reply buffer: every leaf (f32, bf16, int64, a scalar) back bit
    for bit, each view starting on an aligned byte."""
    g = torch.Generator().manual_seed(0)
    tree = {"b": {"w": torch.randn(5, 3, generator=g).to(torch.bfloat16),
                  "beta": torch.tensor([-0.0])},
            "a": torch.randn(7, generator=g),
            "c": torch.arange(3, dtype=torch.int64),
            "nan": torch.tensor([float("nan"), float("-inf")])}
    n = overlap.packed_bytes(tree)
    buf = overlap.pack(tree, torch.full((n,), 255, dtype=torch.uint8))
    back = overlap.unpack(buf, overlap._meta(tree))
    leaves = overlap.tensor_leaves
    for (pa, a), (pb, b) in zip(leaves(tree), leaves(back)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
        assert (b.data_ptr() - buf.data_ptr()) % overlap._ALIGN == 0
    assert n == 5 * overlap._ALIGN


# ---------------------------------------------------------------- the toy

@pytest.mark.parametrize("run", TOY_RUNS)
def test_roles_and_one_trajectory(run, toy):
    reps = toy["runs"][run]
    world = int(run[0])
    assert [r["role"] for r in reps] == ["track"] + ["map"] * (world - 1)
    assert [r["rank"] for r in reps] == list(range(world))
    assert all(r["map_ranks"] == world - 1 for r in reps[1:])
    # each role runs its own iterations only
    assert reps[0]["iters_run"]["map"] == 0 < reps[0]["iters_run"]["track"]
    assert all(r["iters_run"]["track"] == 0 < r["iters_run"]["map"]
               for r in reps[1:])
    est = [np.asarray(r["est7"]) for r in reps]
    assert np.isfinite(est[0]).all()
    assert all(np.array_equal(e, est[0]) for e in est[1:])
    # the last phase's BA pose, landed by every rank's final sync (the
    # tracking rank's from the reply), and the seeds in step
    assert all(r["landed_by_sync"] == [TOY_FRAMES - 1] for r in reps)
    assert all(r["seeds_drawn"] == reps[0]["seeds_drawn"] for r in reps)
    if run == "3+shard":
        # the mapping ranks' row blocks of the brick table
        blocks = [r["table_rows"]["table"] for r in reps[1:]]
        assert blocks[0][0] == 0 and blocks[0][1] == blocks[1][0] > 0
    else:
        assert all(not r["table_rows"] for r in reps)


@pytest.mark.parametrize("run", TOY_RUNS)
def test_mapping_replicas_agree_after_every_phase(run, toy):
    reps = toy["runs"][run]
    for r in reps[1:]:
        assert len(r["replica_checks"]) == r["mapping_cnt"] >= 3
        # compared over the mapping group (one mapping rank: nothing to
        # compare with) the scene, bank, trajectory and Adam state
        assert all(n >= 10 for n in r["replica_checks"])
        assert r["losses"] == reps[1]["losses"]
        assert np.isfinite(r["losses"]).all()
    assert reps[0]["replica_checks"] == [] and reps[0]["losses"] == []


@pytest.mark.parametrize("run", TOY_RUNS)
def test_final_snapshot_is_the_mapping_scene(run, toy):
    """After the final sync() the tracker's snapshot is the mapping scene
    bit for bit (every leaf's bit-pattern checksums)."""
    reps = toy["runs"][run]
    assert "/sdf_mlp/w0" in reps[0]["scene_bits"]
    for r in reps[1:]:
        assert r["scene_bits"] == reps[0]["scene_bits"]


@pytest.mark.parametrize("run", TOY_RUNS)
def test_no_snapshot_older_than_the_previous_phase(run, toy):
    track = toy["runs"][run][0]
    phase, age = np.asarray(track["snapshot_phase"]), \
        np.asarray(track["snapshot_age"])
    # frame 0 takes the ground truth; every other frame is tracked
    assert phase[0] == age[0] == -1
    assert (phase[1:] >= 1).all()          # never the untrained scene
    assert ((age[1:] >= 0) & (age[1:] <= 1)).all(), age
    assert (np.diff(phase[1:]) >= 0).all()


@pytest.mark.parametrize("run", TOY_RUNS)
def test_counts_are_the_sequential_drivers(run, toy):
    for r in toy["runs"][run]:
        assert (r["mapping_cnt"], r["kf_count"]) == toy["sequential"]


def test_lag_witness_tracks_one_phase_behind():
    """`scripts/overlap_lag_witness.py`'s `LaggedSLAM` keeps the tracking
    rank's schedule when every phase outlasts the frames between: a
    tracked frame uses the first phase's scene until the second phase
    has started, then the scene of the phase before the last; the last
    BA pose lands at the final sync."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from overlap_lag_witness import LaggedSLAM

    def bits(tree):
        return [sharding.checksum(t).tolist()
                for _, t in sharding.tensor_leaves(tree)]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, ds = tsim.tiny_slam_config(TOY_FRAMES, False)
        slam = LaggedSLAM(cfg, ds, seed=0, device="cpu")
        scenes, tracked = [None], {}   # each phase's scene; each frame's
        params, map_frame = slam._tracking_params, slam.map_frame

        def tracking_params():
            tracked[len(tracked) + 1] = bits(params())
            return params()

        def mapped(idx, depth, color):
            out = map_frame(idx, depth, color)
            scenes.append(bits(slam.params))
            return out
        slam._tracking_params, slam.map_frame = tracking_params, mapped
        started = []   # phases that had started before each frame
        for i in range(TOY_FRAMES):
            started.append(slam.mapping_cnt)
            slam.step_frame(i)
        before = slam.est_c2w.copy()
        slam.sync()
        slam.close()
    finally:
        torch.set_num_threads(threads)
    assert slam.snapshot_phase[0] == -1
    assert slam.snapshot_phase[1:] == [max(1, n - 1) for n in started[1:]]
    assert max(started) >= 3
    # each frame tracked against the scene its phase left, bit for bit
    assert all(tracked[i] == scenes[slam.snapshot_phase[i]]
               for i in range(1, TOY_FRAMES))
    assert not np.array_equal(before[-1], slam.est_c2w[-1])


# ------------------------------------------------------- the smoke ranks

def _check_ranks(reps):
    assert [r["role"] for r in reps] == ["track"] + ["map"] * (
        len(reps) - 1)
    assert reps[0]["first_step"] is None
    for r in reps[1:]:
        first = r["first_step"]
        assert first["ok"], first
        assert first["tolerance"]["loss_rtol"] == 1e-5
        assert r["replica_checks"] == r["mapping_cnt"]
    assert all(r["est_c2w"] == reps[0]["est_c2w"] for r in reps[1:])
    assert all(r["scene_checksum"] == reps[0]["scene_checksum"]
               for r in reps[1:])
    assert all(r["seeds_drawn"] == reps[0]["seeds_drawn"] > 0 for r in reps)
    assert reps[0]["snapshot_ages"] and set(reps[0]["snapshot_ages"]) <= {
        "0", "1"}
    # rank 1 sent one reply a phase: the scene and 19 floats, aligned
    sends = reps[1]["replies"]
    assert len(sends) == reps[1]["mapping_cnt"]
    assert all(s["bytes"] == sends[0]["bytes"] > 0 and s["ms"] >= 0
               for s in sends)
    assert all("replies" not in r for r in reps[2:] + reps[:1])


def test_every_rank_maps_the_frames_of_the_schedule(small):
    """Every rank mapped the same frames, and they are the schedule's, as
    `chip_smoke.py` holds `overlap_dp_hash`: every second frame and the
    last; a frame off the cadence only where the uncertainty trigger was
    on (the check refuses a missing cadence frame, and an extra one whose
    tracking ran the base iterations)."""
    import chip_smoke
    reps = small["ranks"]
    _, cfg = _small(n_frames=7)
    mapped = reps[0]["mapped_frames"]
    assert all(r["mapped_frames"] == mapped for r in reps[1:])
    assert len(mapped) == reps[1]["mapping_cnt"]
    assert all(r["frame_iters"] == reps[0]["frame_iters"] for r in reps)
    check = chip_smoke.frames_mapped_by_schedule
    assert check(cfg, 7, mapped, reps[0]["frame_iters"])
    assert not check(cfg, 7, [i for i in mapped if i != 2],
                     reps[0]["frame_iters"])
    base = [0] + [cfg["tracking"]["iters"]] * 6
    assert not check(cfg, 7, sorted(set(mapped) | {3}), base)
    assert check(cfg, 7, sorted(set(mapped) | {3}),
                 base[:3] + [2 * base[3]] + base[4:])


def test_first_mapping_iteration_matches_one_rank_on_three(small):
    """(a) on 3 ranks: each mapping rank's first iteration (loss, every
    leaf's summed gradient) against one rank's step on the same draws."""
    _check_ranks(small["ranks"])
    assert small["ranks"][1]["map_ranks"] == 2


def test_first_mapping_iteration_matches_one_rank_on_two(toy):
    _check_ranks(toy["ranks2"])
    assert toy["ranks2"][1]["map_ranks"] == 1


def test_ate_against_the_jax_overlapped_driver(small):
    """(f) under 5 cm and within 1 cm of the JAX package's overlapped
    driver on its 7-device mapping sub-mesh (its median over seeds 0-3,
    measured beside the ranks)."""
    jax_runs = small["jax"]
    assert [r["seed"] for r in jax_runs] == [0, 1, 2, 3]
    assert all(r["map_devices"] == 7 and r["frames"] == 7
               and np.isfinite(r["ate_cm"]) for r in jax_runs)
    est = np.asarray(small["ranks"][0]["est_c2w"])
    _, ate = evaluate_ate(small["gt"][:, :3, 3], est[:, :3, 3])
    ref = statistics.median(r["ate_cm"] for r in jax_runs)
    assert ate["error.rmse"] < ATE_ABS_CM, ate
    assert abs(ate["error.rmse"] - ref) <= ATE_BAND_CM, (ate, ref)


# --------------------------------------------------------------- the CLI

def _cli_ranks(cfg_path, args):
    port = _free_port()
    cmd = [sys.executable, "-m", "unislam_tpu_torch.run", cfg_path,
           "--device", "cpu", *args]
    return _start([cmd] * 3, [{"UNISLAM_COORDINATOR": f"localhost:{port}",
                               "UNISLAM_NUM_PROCESSES": "3",
                               "UNISLAM_PROCESS_ID": str(r)}
                              for r in range(3)])


def test_cli_on_three_ranks_writes_from_one_rank_and_resumes(tmp_path):
    """(g) `python -m unislam_tpu_torch.run` on 3 ranks with
    `parallel.overlap`, 5 frames, then `--resume` to 7: rank 1 writes
    the checkpoints, meshes, `live.json`, `output.txt` (one ATE line a
    run) and `runtime_stats.json`; the resumed run starts at frame 5 on
    every rank."""
    import yaml
    folder = str(tmp_path)
    ds = _write_room(folder)
    cfg = _room_cfg(folder, ds)
    cfg["parallel"] = {"overlap": True}
    cfg_path = os.path.join(folder, "room.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = os.path.join(folder, "output")
    first = _finish(_cli_ranks(cfg_path, ["--n_frames", "5"]), 300)
    info = "INFO: overlapped driver — tracking on rank 0 (cpu), mapping " \
        "on ranks 1..2 (cpu, cpu)"
    assert all(info in o for o in first), first[0][-2000:]
    stats = json.load(open(os.path.join(out, "runtime_stats.json")))
    assert stats["rank"] == 1 and stats["start_frame"] == 0
    assert stats["iters_run"]["track"] == 0 < stats["iters_run"]["map"]
    assert sorted(os.listdir(os.path.join(out, "ckpts"))) == ["00004.npz"]
    assert os.path.exists(os.path.join(out, "config.yaml"))
    assert os.path.isdir(os.path.join(out, "src_snapshot"))

    second = _finish(_cli_ranks(cfg_path, ["--n_frames", "7", "--resume"]),
                     300)
    assert all("at frame 5" in o for o in second), second[0][-2000:]
    stats = json.load(open(os.path.join(out, "runtime_stats.json")))
    assert stats["rank"] == 1 and stats["start_frame"] == 5
    assert sorted(os.listdir(os.path.join(out, "ckpts"))) == [
        "00004.npz", "00006.npz"]
    ates = [json.loads(line) for line in open(os.path.join(out,
                                                           "output.txt"))
            if line.startswith('{"compared_pose_pairs"')]
    assert [a["compared_pose_pairs"] for a in ates] == [5, 7]
    assert ates[-1]["error.rmse"] < ATE_ABS_CM
    live = json.load(open(os.path.join(out, "live.json")))
    assert live["done"] and live["frame"] == 6
    assert "final_mesh_eval_rec.ply" in os.listdir(os.path.join(out,
                                                                "mesh"))
