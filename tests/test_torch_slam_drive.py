"""The port end to end on the CPU: `unislam_tpu_torch.engine.slam.UniSLAM`
alone (no JAX in the loop) drives the procedural room with the settings of
`examples/run_synthetic_slam.py` and must track it to ATE-RMSE < 3 cm, the
bar of the JAX package's own synthetic drive. Also: the port and
`chip_smoke.py` import nothing of JAX, and neither runs without a GPU
unless the CPU is asked for.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "unislam_tpu")


# the brick-encoding settings of `run_synthetic_slam.py --encoding brick`
BRICK = {"grid": {"encoding": "brick", "brick_levels": 3, "brick_features": 8,
                  "brick_hash_size": 12},
         "rendering": {"n_stratified": 24, "n_importance": 8, "n_fine": 10}}


def _drive_config(frames, brick=False):
    from unislam_tpu_torch.core.rays import Intrinsics
    from unislam_tpu_torch.data.synthetic import SyntheticRoom, make_config

    intr = Intrinsics(H=96, W=128, fx=110.0, fy=110.0, cx=63.5, cy=47.5)
    ds = SyntheticRoom(n_frames=frames, intr=intr, deg_per_frame=1.5)
    overrides = {
        "tracking": {"pixels": 800, "iters": 16, "ignore_edge_W": 6,
                     "ignore_edge_H": 6, "lr_T": 0.01, "lr_R": 0.004},
        "mapping": {"pixels": 1000, "iters": 10, "iters_first": 25,
                    "every_frame": 2, "keyframe_every": 2},
        "profiling": {"enabled": True},
    }
    if brick:
        overrides.update(BRICK)
    return make_config(ds, overrides), ds


def test_synthetic_drive_tracks_under_3cm():
    from unislam_tpu_torch.engine.slam import UniSLAM
    from unislam_tpu_torch.tools.eval_ate import pose_evaluation

    frames = 6
    cfg, ds = _drive_config(frames)
    slam = UniSLAM(cfg, ds, seed=0, device="cpu")
    # two intra-op threads: the suite runs several test processes at once
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for i in range(frames):
            slam.step_frame(i)
    finally:
        torch.set_num_threads(threads)
        slam.close()
    _, res = pose_evaluation(slam.gt_c2w, slam.est_c2w)
    assert np.isfinite(res["error.rmse"]) and res["error.rmse"] < 3.0, res
    assert slam.kf_count == slam.bank.count >= 3
    it = slam.iters_run
    assert it["track"] == sum(f["t_iters"] for f in slam.stats.frames)
    assert it["map"] >= 25 + 2 * 10 and it["probe"] == 0
    assert slam.stats.rays["tracking"] == it["track"] * 800


def test_entry_points_need_a_gpu_unless_the_cpu_is_asked_for():
    from unislam_tpu_torch.core.rays import camera_ray_dirs
    from unislam_tpu_torch.engine.keyframes import init_bank
    from unislam_tpu_torch.engine.slam import UniSLAM
    from unislam_tpu_torch.models import (brick_encoding, decoders,
                                          hash_encoding, scene)

    cfg, ds = _drive_config(2)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    sc = scene.make_scene_config(cfg)
    bsc = scene.make_scene_config(_drive_config(2, brick=True)[0])
    gen = torch.Generator().manual_seed(0)
    tree = scene.params_to_numpy(scene.init_params(sc, gen, device="cpu"))
    makers = {
        "UniSLAM": lambda **kw: UniSLAM(cfg, ds, **kw),
        "init_params": lambda **kw: scene.init_params(sc, gen, **kw),
        "params_from_jax": lambda **kw: scene.params_from_jax(tree, **kw),
        "init_table": lambda **kw: hash_encoding.init_table(sc.sdf_spec, gen,
                                                            **kw),
        "brick_init_table": lambda **kw: brick_encoding.init_table(
            bsc.brick_spec, gen, **kw),
        "brick_init_params": lambda **kw: scene.init_params(bsc, gen, **kw),
        "init_mlp": lambda **kw: decoders.init_mlp(8, 16, 1, 2, gen, **kw),
        "init_bank": lambda **kw: init_bank(4, 16, **kw),
        "camera_ray_dirs": lambda **kw: camera_ray_dirs(ds.intr, **kw),
    }
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        with pytest.raises(RuntimeError, match="CUDA"):
            make(device="cuda")
        if name != "UniSLAM":
            out = make(device="cpu")
            leaves = (list(out.values()) if isinstance(out, dict)
                      else [out.depth] if name == "init_bank" else [out])
            assert all(t.device.type == "cpu" for t in leaves
                       if isinstance(t, torch.Tensor)), name
    # the brick + surface-LOD configuration as the repo ships it
    from unislam_tpu_torch.config import load_config
    tpu_cfg = load_config(os.path.join(REPO, "configs/Replica/room0_tpu.yaml"),
                          os.path.join(REPO, "configs/UNISLAM.yaml"))
    with pytest.raises(RuntimeError, match="CUDA"):
        UniSLAM(tpu_cfg, ds)
    # the parallel options run (the runtime picks the overlapped driver)
    for opt in ("data_parallel", "shard_tables", "overlap"):
        UniSLAM({**cfg, "parallel": {opt: True}}, ds, device="cpu").close()


def test_data_parallel_at_world_1_is_bitwise_the_sequential_driver():
    """`parallel.data_parallel` on a one-rank process group (gloo) takes
    the sharded path (whole-batch draws, then the rank's block; summed
    denominators, gradients and losses), with and without
    `shard_tables` (the table gathered through `GatherRows`), and must
    give the sequential driver's trajectory and losses bit for bit."""
    import socket

    import torch.distributed as dist
    from unislam_tpu_torch.parallel import distributed as pdist
    from unislam_tpu_torch.parallel import sim

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        est_seq, loss_seq = sim.run_tiny_slam(None, n_frames=6)
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        pdist.initialize_from_env(f"localhost:{port}", 1, 0,
                                  backend="gloo")
        try:
            group = pdist.global_ray_group()
            assert group.size == 1
            runs = [sim.run_tiny_slam(group, n_frames=6,
                                      shard_tables=shard)
                    for shard in (False, True)]
        finally:
            dist.destroy_process_group()
    finally:
        torch.set_num_threads(threads)
    assert len(loss_seq) >= 3
    for est_dp, loss_dp in runs:
        np.testing.assert_array_equal(est_dp, est_seq)
        assert loss_dp == loss_seq


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "unislam_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO,
                                                        "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
