"""The overlapped tracker/mapper driver (`unislam_tpu_torch.engine.overlap`)
on the CPU, mirroring `tests/test_overlap.py`: placement and the deferred
sync protocol with tracking and mapping on two CPU "devices", end-to-end
quality against the port's sequential driver on the same scene, the
device-count errors, and the runtime's fallback to the sequential driver
on one device. The driver over several processes is
`tests/test_torch_overlap_ranks.py`'s."""

import numpy as np
import pytest
import torch

from unislam_tpu_torch.core import pose as pose_lib
from unislam_tpu_torch.core.rays import Intrinsics
from unislam_tpu_torch.data.synthetic import SyntheticRoom, make_config
from unislam_tpu_torch.engine.overlap import OverlappedSLAM
from unislam_tpu_torch.engine.slam import UniSLAM
from unislam_tpu_torch.tools.eval_ate import evaluate_ate


def _small(n_frames=9, **overrides):
    ds = SyntheticRoom(n_frames=n_frames,
                       intr=Intrinsics(H=40, W=52, fx=45.0, fy=45.0,
                                       cx=25.5, cy=19.5),
                       deg_per_frame=1.5)
    base = {"tracking": {"pixels": 600, "iters": 16, "ignore_edge_W": 3,
                         "ignore_edge_H": 3, "lr_T": 0.01, "lr_R": 0.004},
            "mapping": {"pixels": 800, "iters": 8, "iters_first": 25,
                        "every_frame": 2, "keyframe_every": 2},
            "rendering": {"n_stratified": 16, "n_importance": 4},
            "data": {"prefetch": False}}
    from unislam_tpu_torch.config import update_recursive
    update_recursive(base, overrides)
    return ds, make_config(ds, base)


N_FRAMES = 7


@pytest.fixture(scope="module")
def overlapped():
    """7 frames of the overlapped driver, tracking and mapping on two CPU
    "devices", with what the deferred sync showed along the way."""
    ds, cfg = _small(n_frames=N_FRAMES)
    with _threads(2):
        slam = OverlappedSLAM(cfg, ds, seed=0, track_device="cpu",
                              map_devices=["cpu"])
        seen = {"placement": (slam.track_device, slam.map_device,
                              slam.device, slam.tracker.device),
                # the tracker's snapshot is a copy, not the mapper's storage
                "snapshot_is_copy": slam._track_params["sdf_table"]
                .data_ptr() != slam.params["sdf_table"].data_ptr()}
        # every_frame 2: mapping at 0, 2, 4, 6
        for i in range(3):
            slam.step_frame(i)
        seen["pending_after_map"] = isinstance(slam._pending_loss,
                                               torch.Tensor)
        seen["pending_loss"] = float(slam._pending_loss)
        snap = slam._next_snapshot[0]
        slam.step_frame(3)   # tracking adopts the finished snapshot
        seen["adopted"] = (slam._next_snapshot is None
                           and slam._track_params is snap)
        slam.step_frame(4)   # the next mapping frame lands the last phase
        seen["landed_loss"] = slam.last_map_loss
        seen["pending_again"] = slam._pending_loss is not None
        for i in range(5, N_FRAMES):
            slam.step_frame(i)
        slam.sync()
        seen["after_sync"] = (slam._pending_loss, slam._pending_ba,
                              slam._next_snapshot)
        # a BA pose (joint BA needs more than 4 keyframes, which 7 frames
        # do not reach) is deferred the same way
        before = slam.est_c2w[6].copy()
        pose7 = torch.tensor([0.0, 1.0, 0.0, 0.0, 0.1, 0.2, 0.3])
        slam._writeback_ba_pose(6, pose7)
        seen["ba_deferred"] = np.array_equal(slam.est_c2w[6], before)
        slam.sync()
        seen["ba_landed"] = slam.est_c2w[6].tolist() == pose_lib.\
            cam_pose_to_matrix(pose7[None])[0].numpy().tolist()
        slam.est_c2w[6] = before
        seen["snapshot_equals_map"] = all(
            torch.equal(a, b) for a, b in zip(
                _tensors(slam._track_params), _tensors(slam.params)))
        slam.close()
    return slam, seen


def _tensors(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_tensors(v) if isinstance(v, dict) else (v,))


class _threads:
    """Two intra-op threads: the suite runs several test processes."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        self.old = torch.get_num_threads()
        torch.set_num_threads(self.n)

    def __exit__(self, *exc):
        torch.set_num_threads(self.old)


def test_placement_and_deferred_sync(overlapped):
    slam, seen = overlapped
    cpu = torch.device("cpu")
    assert seen["placement"] == (cpu,) * 4
    assert seen["snapshot_is_copy"]
    assert seen["pending_after_map"] and np.isfinite(seen["pending_loss"])
    assert seen["adopted"]
    assert seen["landed_loss"] == seen["pending_loss"]
    assert seen["pending_again"]
    assert seen["after_sync"] == (None, None, None)
    assert seen["ba_deferred"] and seen["ba_landed"]
    assert seen["snapshot_equals_map"]
    assert np.isfinite(slam.last_map_loss)


def test_overlap_matches_the_sequential_driver(overlapped):
    """The lagging snapshot (the reference's two-process tracker) tracks
    the room as the sequential driver does: ATE under 5 cm and within 1 cm
    of it, with the BA write-backs landed."""
    ds, cfg = _small(n_frames=N_FRAMES)
    with _threads(2):
        seq = UniSLAM(cfg, ds, seed=0, device="cpu")
        est_seq = seq.run()
        seq.close()
    _, r_seq = evaluate_ate(seq.gt_c2w[:, :3, 3], est_seq[:, :3, 3])
    ovl = overlapped[0]
    _, r_ovl = evaluate_ate(ovl.gt_c2w[:, :3, 3], ovl.est_c2w[:, :3, 3])

    assert r_seq["error.rmse"] < 5.0, r_seq
    assert r_ovl["error.rmse"] < 5.0, r_ovl
    assert abs(r_ovl["error.rmse"] - r_seq["error.rmse"]) < 1.0
    assert ovl.mapping_cnt == seq.mapping_cnt >= 4
    assert ovl.kf_count == seq.kf_count >= 4


def test_device_count_errors():
    ds, cfg = _small(n_frames=3)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match=">= 2 devices"):
            OverlappedSLAM(cfg, ds)
    # a ray-sharded mapping side is one process a device
    with pytest.raises(ValueError, match="one process a device.*UNISLAM_"
                       ".*unislam_tpu_torch.run"):
        OverlappedSLAM(cfg, ds, track_device="cpu",
                       map_devices=["cpu", "cpu"])


def test_runtime_on_one_device_runs_the_sequential_driver(tmp_path, capsys):
    from unislam_tpu_torch.runtime import SLAMRuntime

    ds, cfg = _small(n_frames=2, parallel={"overlap": True})
    if torch.cuda.device_count() >= 2:
        pytest.skip("two devices are visible")
    rt = SLAMRuntime(cfg, output=str(tmp_path), dataset=ds, device="cpu")
    out = capsys.readouterr().out
    assert ("INFO: parallel.overlap requested but only one device is "
            "visible; using the sequential driver") in out
    assert type(rt.slam) is UniSLAM
    assert rt.writer
    rt.slam.close()
