"""The port's runtime surface: checkpoints (a round trip, an archive the
JAX package wrote, an archive the port wrote read by the JAX package, and
the resume into a smaller bank that keeps the newest keyframes, against
the JAX `load_into`), the SLAM loop's hooks, the per-iteration visualisation
path against the plain one (identical numerics), the next frame's staging,
and `SLAMRuntime` end to end on a tiny on-disk Replica (the CLI is in
`tests/test_torch_cli.py`).

Arrays carried through a checkpoint must come back bitwise.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from unislam_tpu.data.synthetic import SyntheticRoom as JRoom
from unislam_tpu.data.synthetic import make_config as jmake_config
from unislam_tpu.engine import keyframes as jkf
from unislam_tpu.engine.slam import UniSLAM as JSLAM
from unislam_tpu.utils import logger as jlogger
from unislam_tpu_torch.core.rays import Intrinsics
from unislam_tpu_torch.data.synthetic import SyntheticRoom, make_config
from unislam_tpu_torch.data.synthetic import write_replica
from unislam_tpu_torch.engine import keyframes as tkf
from unislam_tpu_torch.engine.slam import UniSLAM
from unislam_tpu_torch.models import scene as tscene
from unislam_tpu_torch.utils import logger as tlogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = Intrinsics(H=24, W=32, fx=30.0, fy=30.0, cx=15.5, cy=11.5)
SMALL = {"tracking": {"pixels": 150, "iters": 3, "ignore_edge_W": 3,
                      "ignore_edge_H": 3, "lr_T": 0.01, "lr_R": 0.004},
         "mapping": {"pixels": 200, "iters": 3, "iters_first": 4,
                     "every_frame": 2, "keyframe_every": 2},
         "rendering": {"n_stratified": 8, "n_importance": 4},
         "grid": {"hash_size_sdf": 10, "hash_size_color": 10,
                  "voxel_sdf": 0.05, "voxel_color": 0.05},
         "data": {"prefetch": False}}


def _tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _bank_equal(tbank, jbank):
    for k in tkf.BANK_FIELDS:
        np.testing.assert_array_equal(getattr(tbank, k).cpu().numpy(),
                                      np.asarray(getattr(jbank, k)))
    assert tbank.count == int(np.asarray(jbank.count))


def _jax_slam(n_frames, n_kf, seed=0):
    """A JAX UniSLAM with random scene leaves, `n_kf` keyframes and random
    host state, as a run would have left it."""
    ds = JRoom(n_frames=n_frames, intr=TINY)
    cfg = jmake_config(ds, SMALL)
    slam = JSLAM(cfg, ds, seed=seed)
    rs = np.random.default_rng(seed)
    slam.params = jax.tree_util.tree_map(
        lambda x: rs.normal(size=np.shape(x)).astype(np.float32),
        slam.params)
    add = jkf.make_add_keyframe(TINY.H, TINY.W, slam.bank_size)
    for k in range(n_kf):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = rs.normal(size=3) * 0.1
        slam.bank = add(slam.bank, rs.random((TINY.H, TINY.W)).astype(
            np.float32), rs.random((TINY.H, TINY.W, 3)).astype(np.float32),
            np.asarray(slam.cam_rays_d), c2w, c2w, k * 2,
            jax.random.PRNGKey(k))
        slam.kf_count += 1
        slam.kf_is_cadence[k] = k % 2 == 0
    slam.est_c2w[:] = rs.normal(size=slam.est_c2w.shape)
    slam.gt_c2w[:] = rs.normal(size=slam.gt_c2w.shape)
    slam.tracking_weights[:] = rs.random(n_frames)
    slam.additional_map_records[:] = rs.integers(0, 2, n_frames)
    slam.t_iters, slam.m_iters, slam.tracking_back = 16, 30, True
    slam.lc_cnt, slam.mapping_cnt, slam.init_phase = 2, 5, False
    return slam, cfg


def _port_slam(n_frames, seed=1):
    ds = SyntheticRoom(n_frames=n_frames, intr=TINY)
    return UniSLAM(make_config(ds, SMALL), ds, seed=seed, device="cpu")


def _host_state_equal(t, j, n):
    for name in ("est_c2w", "gt_c2w", "tracking_weights",
                 "additional_map_records"):
        np.testing.assert_array_equal(getattr(t, name)[:n],
                                      getattr(j, name)[:n])
    for name in ("t_iters", "m_iters", "tracking_back", "lc_cnt",
                 "mapping_cnt", "init_phase"):
        assert getattr(t, name) == getattr(j, name)


def test_jax_archive_resumes_in_the_port(tmp_path):
    jslam, _ = _jax_slam(8, 3)
    path = jlogger.save_checkpoint(str(tmp_path / "00005.npz"), jslam, 5)
    tslam = _port_slam(8)
    assert tlogger.load_into(tslam, path) == 6
    _tree_equal(tscene.params_to_numpy(tslam.params),
                jax.tree_util.tree_map(np.asarray, jslam.params))
    _bank_equal(tslam.bank, jslam.bank)
    np.testing.assert_array_equal(tslam.kf_is_cadence, jslam.kf_is_cadence)
    _host_state_equal(tslam, jslam, 8)
    assert tslam.kf_count == 3


def test_port_archive_round_trip_and_read_by_jax(tmp_path):
    jslam, _ = _jax_slam(8, 3)
    tslam = _port_slam(8)
    tlogger.load_into(tslam, jlogger.save_checkpoint(
        str(tmp_path / "a.npz"), jslam, 5))
    path = tlogger.save_checkpoint(str(tmp_path / "ckpts" / "00005.npz"),
                                   tslam, 5)
    assert tlogger.latest_checkpoint(str(tmp_path / "ckpts")) == path
    assert not glob.glob(str(tmp_path / "ckpts" / "*.tmp*"))
    ours, theirs = tlogger.load_checkpoint(path), jlogger.load_checkpoint(
        str(tmp_path / "a.npz"))
    assert ours.keys() == theirs.keys()
    for k in ours:
        if k == "meta":
            assert ours[k] == theirs[k]
        else:
            assert ours[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(ours[k], theirs[k])
    again = _port_slam(8, seed=2)
    assert tlogger.load_into(again, path) == 6
    _tree_equal(tscene.params_to_numpy(again.params),
                tscene.params_to_numpy(tslam.params))
    j2, _ = _jax_slam(8, 0, seed=3)
    assert jlogger.load_into(j2, path) == 6
    _bank_equal(again.bank, j2.bank)


def test_fused_decoder_archive_crosses_both_ways(tmp_path):
    """With `grid.tcnn_network: true` the decoders are bias-free {w0, w1}
    in both packages: a JAX run's archive resumes in the port, and the
    port's archive in the JAX package, leaf for leaf."""
    fused = {**SMALL, "grid": {**SMALL["grid"], "tcnn_network": True}}
    jds = JRoom(n_frames=6, intr=TINY)
    jslam = JSLAM(jmake_config(jds, fused), jds, seed=0)
    rs = np.random.default_rng(0)
    jslam.params = jax.tree_util.tree_map(
        lambda x: rs.normal(size=np.shape(x)).astype(np.float32),
        jslam.params)
    path = jlogger.save_checkpoint(str(tmp_path / "00003.npz"), jslam, 3)
    ds = SyntheticRoom(n_frames=6, intr=TINY)
    tslam = UniSLAM(make_config(ds, fused), ds, seed=1, device="cpu")
    assert sorted(tslam.params["sdf_mlp"]) == ["w0", "w1"]
    assert tlogger.load_into(tslam, path) == 4
    _tree_equal(tscene.params_to_numpy(tslam.params),
                jax.tree_util.tree_map(np.asarray, jslam.params))
    back = tlogger.save_checkpoint(str(tmp_path / "ckpts" / "00003.npz"),
                                   tslam, 3)
    j2 = JSLAM(jmake_config(jds, fused), jds, seed=2)
    assert jlogger.load_into(j2, back) == 4
    _tree_equal(jax.tree_util.tree_map(np.asarray, j2.params),
                tscene.params_to_numpy(tslam.params))


@pytest.mark.parametrize("n_small", [3, 8])
def test_resume_into_another_bank_size_matches_jax(tmp_path, n_small):
    """A checkpoint of a 12-frame run (12 slots, 5 keyframes) resumed by a
    run with 3 slots keeps the newest 3 keyframes, and by one with 8 slots
    all 5: as the JAX load_into does."""
    jbig, _ = _jax_slam(12, 5)
    path = jlogger.save_checkpoint(str(tmp_path / "00009.npz"), jbig, 9)
    jsmall, _ = _jax_slam(n_small, 0, seed=4)
    tsmall = _port_slam(n_small)
    assert jlogger.load_into(jsmall, path) == tlogger.load_into(tsmall,
                                                                path) == 10
    _bank_equal(tsmall.bank, jsmall.bank)
    np.testing.assert_array_equal(tsmall.kf_is_cadence, jsmall.kf_is_cadence)
    _host_state_equal(tsmall, jsmall, n_small)
    keep = min(n_small, 5)
    assert tsmall.kf_count == keep
    np.testing.assert_array_equal(
        tsmall.bank.frame_idx[:keep].numpy(),
        np.asarray(jbig.bank.frame_idx)[5 - keep:5])


# ---------------------------------------------------------------- SLAM loop

class _Vis:
    def __init__(self, log, render=None):
        self.inside_freq, self.log, self.render = 2, log, render

    def wants(self, idx):
        return idx > 0

    def __call__(self, slam, idx, it, x):
        self.log.append((idx, it))
        if self.render is not None and it == 0:
            self.render(slam, x)


def _run(slam, n, with_vis):
    hooks = []
    slam.on_frame_done = lambda s, i: hooks.append(("frame", i))
    slam.on_mapping_done = lambda s, i: hooks.append(("map", i))
    vis = {"track": [], "map": []}
    if with_vis:
        from unislam_tpu_torch.core import pose as pose_lib
        from unislam_tpu_torch.core import rng
        from unislam_tpu_torch.render.renderer import render_img

        def render_track(s, pose7):
            c2w = pose_lib.cam_pose_to_matrix(pose7[None])[0]
            render_img(s.params, s.sc, s.rc, s.intr, c2w,
                       rng.generator(99))

        def render_map(s, state):
            c2w = pose_lib.cam_pose_to_matrix(state["poses"][-1:])[0]
            render_img(state["scene"], s.sc, s.rc, s.intr, c2w.detach(),
                       rng.generator(98))
        slam.tracking_iter_vis = _Vis(vis["track"], render_track)
        slam.mapping_iter_vis = _Vis(vis["map"], render_map)
    for i in range(n):
        slam.step_frame(i)
    return hooks, vis


def test_hooks_and_per_iteration_path_match_the_plain_path():
    """The frames a vis hook claims run the same iterations with the
    callback (and a full render) between them: the trajectory and the map
    come out bitwise the plain path's. The hooks fire after each frame and
    after each mapping phase, in order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        a, b = _port_slam(5), _port_slam(5)
        hooks_a, _ = _run(a, 5, False)
        hooks_b, vis = _run(b, 5, True)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(a.est_c2w, b.est_c2w)
    _tree_equal(tscene.params_to_numpy(a.params),
                tscene.params_to_numpy(b.params))
    # a mapping phase (cadence or tracking-back) hooks before its frame's
    assert hooks_a == hooks_b
    assert [i for k, i in hooks_b if k == "frame"] == list(range(5))
    maps = [i for k, i in hooks_b if k == "map"]
    assert {0, 2, 4} <= set(maps)
    for i in maps:
        assert hooks_b.index(("map", i)) + 1 == hooks_b.index(("frame", i))
    # tracking of frames 1-4: iterations 0, 2 and the last of each run
    track = {}
    for idx, it in vis["track"]:
        track.setdefault(idx, []).append(it)
    assert sorted(track) == [1, 2, 3, 4]
    for idx, its in track.items():
        assert its[:2] == [0, 2] and its[-1] in (2, 5)
    assert sorted({i for i, _ in vis["map"]}) == [i for i in maps if i > 0]


def test_next_frame_is_staged_and_read_once():
    """With the prefetcher, each frame is read from the dataset once; a
    frame whose decode finished while the one before ran arrives staged
    (already copied), and UniSLAM uses it."""
    ds = SyntheticRoom(n_frames=4, intr=TINY)
    reads = []

    class Counting:
        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            reads.append(i)
            return ds[i]
    cfg = make_config(ds, {**SMALL, "data": {"prefetch": True}})
    slam = UniSLAM(cfg, Counting(), seed=0, device="cpu")
    staged = []
    real = slam._upload

    def spy(color, depth):
        staged.append(slam._staged_frame)
        return real(color, depth)
    slam._upload = spy
    import time
    for i in range(4):
        color, depth, gt = slam._frame(i)
        np.testing.assert_array_equal(color.numpy(), ds[i][0])
        np.testing.assert_array_equal(depth.numpy(), ds[i][1])
        time.sleep(0.05)             # the next decode finishes meanwhile
    slam.close()
    assert sorted(reads) == [0, 1, 2, 3]
    assert max(slam._frames.reads.values()) == 1
    assert slam._staged_frame is None or slam._staged_frame[0] == 4


# ---------------------------------------------------------------- runtime

def _write_room(folder, n=7):
    ds = SyntheticRoom(n_frames=n, intr=Intrinsics(
        H=40, W=52, fx=45.0, fy=45.0, cx=25.5, cy=19.5), deg_per_frame=1.5)
    write_replica([ds[i] for i in range(n)], os.path.join(folder, "room"))
    return ds


def _room_cfg(folder, ds):
    return {
        "inherit_from": os.path.join(REPO, "configs/Replica/replica.yaml"),
        "mapping": {"bound": ds.bound, "marching_cubes_bound": ds.bound,
                    "pixels": 500, "iters": 5, "iters_first": 20,
                    "every_frame": 2, "keyframe_every": 2, "mesh_freq": 4,
                    "ckpt_freq": 4, "vis_freq": 4, "vis_inside_freq": 2},
        "tracking": {"pixels": 300, "iters": 6, "ignore_edge_W": 3,
                     "ignore_edge_H": 3, "lr_T": 0.01, "lr_R": 0.004,
                     "vis_freq": 6, "vis_pose_freq": 4,
                     "vis_inside_freq": 3},
        "rendering": {"n_stratified": 12, "n_importance": 4},
        "grid": {"hash_size_sdf": 12, "hash_size_color": 12,
                 "voxel_sdf": 0.03, "voxel_color": 0.03},
        "meshing": {"resolution": 0.06},
        "cam": {"H": 40, "W": 52, "fx": 45.0, "fy": 45.0, "cx": 25.5,
                "cy": 19.5, "png_depth_scale": 6553.5, "crop_edge": 0},
        "data": {"input_folder": os.path.join(folder, "room"),
                 "output": os.path.join(folder, "output")}}


def test_runtime_end_to_end_on_disk(tmp_path):
    from unislam_tpu_torch.config import load_config, update_recursive
    from unislam_tpu_torch.runtime import SLAMRuntime

    folder = str(tmp_path)
    ds = _write_room(folder)
    cfg = load_config(os.path.join(REPO, "configs/Replica/replica.yaml"),
                      os.path.join(REPO, "configs/UNISLAM.yaml"))
    leaf = _room_cfg(folder, ds)
    leaf.pop("inherit_from")
    update_recursive(cfg, leaf)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rt = SLAMRuntime(cfg, device="cpu")
        rt.run()
    finally:
        torch.set_num_threads(threads)
    out = cfg["data"]["output"]
    assert np.abs(rt.slam.est_c2w[:, :3, 3]
                  - rt.slam.gt_c2w[:, :3, 3]).max() < 0.2
    assert sorted(os.listdir(os.path.join(out, "ckpts"))) == [
        "00004.npz", "00006.npz"]
    meshes = sorted(os.listdir(os.path.join(out, "mesh")))
    assert meshes == ["00004_mesh.ply", "final_mesh_eval_rec.ply",
                      "final_mesh_eval_rec_culled.ply"]
    lines = open(os.path.join(out, "output.txt")).read()
    assert "error.rmse" in lines and "avg_psnr" in lines
    assert len(os.listdir(os.path.join(out, "rendered_image"))) == 2
    assert glob.glob(os.path.join(out, "tracking_vis", "00006_0000.jpg"))
    assert glob.glob(os.path.join(out, "mapping_vis", "render_img_4",
                                  "*.png"))
    live = json.load(open(os.path.join(out, "live.json")))
    assert live["done"] and live["frame"] == 6 and live["mesh"]
    stats = json.load(open(os.path.join(out, "runtime_stats.json")))
    assert stats["start_frame"] == 0 and stats["frame_reads"] == {
        "frames": 7, "max": 1}
    assert {"frames", "eval_rendering", "mesh", "cull", "checkpoint"} <= \
        set(stats["phases_s"])
    assert stats["render_img"]["images"] == 2
    assert len(stats["meshes"]) == 2
    assert stats["launches_run"] == {}        # the CPU launches no kernel
    assert stats["host_max_rss_gb"] > 0


def test_profiling_and_live_state_match_jax(tmp_path):
    """PhaseStats' summary and per-frame dump, and the live state feed,
    written as the JAX package writes them for the same inputs."""
    from unislam_tpu.utils import playback as jplay
    from unislam_tpu.utils.profiling import PhaseStats as JStats
    from unislam_tpu_torch.utils import playback as tplay
    from unislam_tpu_torch.utils.profiling import PhaseStats as TStats

    texts, dumps = [], []
    for cls, name in ((JStats, "j"), (TStats, "t")):
        st = cls()
        for k, (t, r, c) in {"tracking": (1.25, 16000, 2),
                             "mapping": (3.5, 63000, 1),
                             "hooks": (0.125, 0, 3)}.items():
            st.time_s[k], st.rays[k], st.calls[k] = t, r, c
        st.frames = [{"idx": 0, "phases": {"mapping": 3.5}, "t": 3.6,
                      "mapped": True}]
        texts.append(st.summary())
        st.dump_frames(str(tmp_path / f"{name}.json"))
        dumps.append(json.load(open(tmp_path / f"{name}.json")))
    assert texts[0] == texts[1] and dumps[0] == dumps[1]

    rs = np.random.default_rng(0)
    est, gt = rs.normal(size=(6, 4, 4)), rs.normal(size=(6, 4, 4))
    states = []
    for mod, name in ((jplay, "j"), (tplay, "t")):
        out = tmp_path / name
        (out / "mesh").mkdir(parents=True)
        for m in ("00002_mesh.ply", "00004_mesh.ply",
                  "00004_mesh_culled.ply"):
            (out / "mesh" / m).write_text("")
        mod.write_live_state(str(out), 4, 6, est, gt)
        st = mod.read_live_state(str(out))
        st.pop("timestamp")
        st["mesh"] = os.path.relpath(st["mesh"], out)
        states.append(st)
        assert mod.mesh_snapshot_for_frame(str(out / "mesh"), 3).endswith(
            "00002_mesh.ply")
    assert states[0] == states[1] and states[1]["mesh"] == os.path.join(
        "mesh", "00004_mesh.ply")
    assert tplay.read_live_state(str(tmp_path / "none")) is None
