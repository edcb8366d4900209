"""The tracker's graphed iteration (`unislam_tpu_torch/engine/tracker.py`:
`TrackGraph`, `PoseLeaves`, `Tracker.frame_pose`).

On the CPU, where the tracker runs its eager loop, the graph's parts run
eagerly: the draws it takes into its buffers are the draws `loss_fn`
takes from the same generator, its iteration (`TrackGraph.run`) is the
eager step bit for bit, and the persistent leaves reset in place give the
numbers of fresh ones. Also the counters and spans it adds and the
benchmark's reader of its share.

On the card (marked `cuda`, skipped without a CUDA device), the graphed
step against the eager step on fresh leaves and torch's Adam, bit for
bit, on the hash configuration (also with a fixed beta) and the brick
configuration (also with its low-precision options), and the leaves' own
Adam against torch's:

    python -m pytest --noconftest -m cuda tests/test_torch_track_graph.py

(this file imports no JAX, so it runs without the test configuration).
"""

import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if p not in sys.path:
        sys.path.insert(0, p)

from unislam_tpu_torch.core import rng  # noqa: E402
from unislam_tpu_torch.engine import tracker as tracker_lib  # noqa: E402
from unislam_tpu_torch.utils import profiling  # noqa: E402

SMALL = {"tracking": {"pixels": 64, "iters": 3, "ignore_edge_W": 2,
                      "ignore_edge_H": 2},
         "mapping": {"pixels": 96, "iters": 2, "iters_first": 3,
                     "every_frame": 2, "keyframe_every": 2},
         "rendering": {"n_stratified": 8, "n_importance": 4}}


# the brick configuration's low-precision options (fused bf16 decoders,
# K4, in the tracking iteration; bf16 Adam state for the mapped table)
LOWP = {"grid": {"tcnn_network": True},
        "mapping": {"adam_state_dtype": "bfloat16"}}


def _slam(device, variant="hash", size=(24, 32), frames=4, overrides=SMALL):
    """A UniSLAM on the procedural room that has mapped frame 0;
    `variant` "hash", "hash_fixed_beta" (the render's beta a constant, as
    TUM RGB-D's settings have it), "brick" or "brick_lowp"."""
    from test_torch_slam_drive import BRICK

    from unislam_tpu_torch.config import update_recursive
    from unislam_tpu_torch.core.rays import Intrinsics
    from unislam_tpu_torch.data.synthetic import SyntheticRoom, make_config
    from unislam_tpu_torch.engine.slam import UniSLAM

    H, W = size
    intr = Intrinsics(H=H, W=W, fx=0.9 * W, fy=0.9 * W, cx=W / 2 - 0.5,
                      cy=H / 2 - 0.5)
    ds = SyntheticRoom(n_frames=frames, intr=intr, deg_per_frame=1.5)
    over = copy.deepcopy(overrides)
    if variant.startswith("brick"):
        update_recursive(over, copy.deepcopy(BRICK))
    if variant == "hash_fixed_beta":
        update_recursive(over, {"rendering": {"learnable_beta": False}})
    if variant == "brick_lowp":
        update_recursive(over, copy.deepcopy(LOWP))
    slam = UniSLAM(make_config(ds, over), ds, seed=0, device=device)
    slam.step_frame(0)
    return slam


def _frame(slam, idx):
    color, depth, _ = slam.dataset[idx]
    dev = slam.device
    return (torch.as_tensor(depth, dtype=torch.float32, device=dev),
            torch.as_tensor(color, dtype=torch.float32, device=dev))


def _pose7(slam, idx):
    from unislam_tpu_torch.core import pose as pose_lib

    _, _, c2w = slam.dataset[idx]
    p7 = pose_lib.matrix_to_cam_pose(
        torch.as_tensor(c2w, dtype=torch.float32)[None])[0]
    # off the true pose, so the loss has a slope
    return (p7 + torch.tensor([0.002, -0.001, 0.0, 0.001,
                               0.01, -0.005, 0.004])).to(slam.device)


@pytest.fixture(scope="module")
def cpu_slam():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    slam = _slam("cpu")
    yield slam
    slam.close()
    torch.set_num_threads(threads)


# -- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("handed", [(), ("i", "j"), ("t_depth",),
                                    ("i", "j", "t_depth")],
                         ids=["none", "pixels", "jitter", "all"])
def test_taken_draws_are_the_draws_loss_fn_takes(cpu_slam, handed):
    """`take` fills the buffers with the draws `loss_fn` takes from the
    same generator (rows, columns, then the renderer's jitter), or with
    the ones handed in; the loss on the buffers is `loss_fn`'s, bitwise,
    and both leave the generator in the same state."""
    slam = cpu_slam
    tr, tc, intr = slam.tracker, slam.tc, slam.intr
    depth, color = _frame(slam, 1)
    pose = tracker_lib.make_pose(_pose7(slam, 1))
    n, S = tc.pixels, slam.rc_track.n_stratified + slam.rc_track.n_importance

    ref = rng.generator(11)
    want = {"j": torch.randint(tc.ignore_edge_H, intr.H - tc.ignore_edge_H,
                               (n,), generator=ref),
            "i": torch.randint(tc.ignore_edge_W, intr.W - tc.ignore_edge_W,
                               (n,), generator=ref),
            "t_depth": torch.rand(n, S, generator=ref)}
    other = rng.generator(12)
    given = {"j": torch.randint(0, intr.H, (n,), generator=other),
             "i": torch.randint(0, intr.W, (n,), generator=other),
             "t_depth": torch.rand(n, S, generator=other)}
    draws = {k: given[k] for k in handed}
    if "t_depth" in handed and "i" not in handed:
        # the generator's first numbers go to the pixels
        want["t_depth"] = given["t_depth"]
    if "i" in handed:
        want["i"], want["j"] = given["i"], given["j"]
        if "t_depth" not in handed:
            g = rng.generator(11)
            want["t_depth"] = torch.rand(n, S, generator=g)
        else:
            want["t_depth"] = given["t_depth"]

    gen_a = rng.generator(11)
    loss_a, unc_a = tr.loss_fn(pose, slam.params, depth, color, gen_a,
                               draws or None)
    graph = tracker_lib.TrackGraph(tr)
    gen_b = rng.generator(11)
    graph.take(gen_b, draws or None, depth, color)
    for k in ("i", "j"):
        assert torch.equal(graph.pixels[k], want[k]), k
    assert torch.equal(graph.render["t_depth"], want["t_depth"])
    assert torch.equal(graph.gt_depth, depth[want["j"], want["i"]])
    assert torch.equal(graph.gt_color, color[want["j"], want["i"]])
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    loss_b, unc_b = tr.pixel_loss(
        pose, slam.params, graph.pixels["i"].float(),
        graph.pixels["j"].float(), graph.gt_depth, graph.gt_color, None,
        graph.render)
    assert torch.equal(loss_a, loss_b) and torch.equal(unc_a, unc_b)


def test_graph_iteration_run_eagerly_is_the_eager_step(cpu_slam):
    """Three iterations of `take` + `TrackGraph.run` on the persistent
    leaves give the eager `Tracker.step`'s loss, uncertainty, median,
    gradients and stepped leaves, bit for bit."""
    slam = cpu_slam
    tr = slam.tracker
    depth, color = _frame(slam, 1)
    p7 = _pose7(slam, 1)
    pose = tracker_lib.make_pose(p7)
    opt = tracker_lib.make_optimizer(slam.tc, pose)
    graph = tracker_lib.TrackGraph(tr)
    gpose, _ = graph.leaves.reset(p7)
    for it in range(3):
        loss, unc = tr.step(slam.params, pose, opt, depth, color,
                            rng.generator(rng.fold_in(7, it)))
        median = tr.last_median
        graph.take(rng.generator(rng.fold_in(7, it)), None, depth, color)
        out = graph.run(slam.params)
        assert torch.equal(out, torch.stack([loss, unc, median])), it
        for k in ("R", "T"):
            assert torch.equal(gpose[k].grad, pose[k].grad), (it, k)
            assert torch.equal(gpose[k], pose[k]), (it, k)


def test_reset_leaves_give_the_numbers_of_fresh_ones(cpu_slam):
    """Two frames (each doubled through `carry`) on `PoseLeaves`, its own
    Adam, reset in place give the numbers of fresh `make_pose` /
    `make_optimizer` leaves (torch's Adam), bit for bit."""
    slam = cpu_slam
    tr = slam.tracker
    leaves = tracker_lib.PoseLeaves(slam.tc, "cpu")
    for idx, seed in ((1, 5), (2, 6)):
        depth, color = _frame(slam, idx)
        p7 = _pose7(slam, idx)
        fresh = tracker_lib.make_pose(p7)
        fopt = tracker_lib.make_optimizer(slam.tc, fresh)
        kept, kopt = leaves.reset(p7)
        states = []
        for pose, opt in ((fresh, fopt), (kept, kopt)):
            st = tr.track_frame(slam.params, pose, opt, depth, color, seed, 3)
            states.append(tr.track_frame(slam.params, pose, opt, depth,
                                         color, seed, 3, iter0=3, carry=st))
        for a, b in zip(*states):
            assert torch.equal(a, b), idx
        for n, k in enumerate(("R", "T")):
            assert torch.equal(fresh[k], kept[k]), (idx, k)
            st = fopt.state[fresh[k]]
            assert int(st["step"]) == kopt.t == 6
            assert torch.equal(st["exp_avg"], kopt.exp_avg[n]), (idx, k)
            assert torch.equal(st["exp_avg_sq"], kopt.exp_avg_sq[n]), (idx, k)


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_pose_adam_is_torch_adam(device):
    """`PoseLeaves`' Adam against `make_optimizer`'s over 40 steps of
    gradients from 1e-9 to 1e3 (past its table's first 12 steps), bit
    for bit, and again after a reset."""
    if device == "cuda":
        _card()
    tc = tracker_lib.TrackerConfig(iters=3, lr_R=0.003, lr_T=0.01)
    g = torch.Generator().manual_seed(5)
    p7 = torch.randn(7, generator=g)
    leaves = tracker_lib.PoseLeaves(tc, device)
    for _ in range(2):
        pose, opt = leaves.reset(p7.to(device))
        ref = tracker_lib.make_pose(p7.to(device))
        ref_opt = tracker_lib.make_optimizer(tc, ref)
        for t in range(40):
            for k, n in (("R", 4), ("T", 3)):
                grad = (torch.randn(n, generator=g)
                        * 10.0 ** torch.randint(-9, 4, (n,), generator=g))
                pose[k].grad = grad.to(device)
                ref[k].grad = grad.to(device)
            opt.step()
            ref_opt.step()
            for k in ("R", "T"):
                assert torch.equal(pose[k], ref[k]), (t, k)


def test_the_cpu_and_ray_groups_get_fresh_leaves(cpu_slam):
    """Off a CUDA device `frame_pose` hands out fresh leaves each frame
    and `step` runs the eager loop."""
    tr = cpu_slam.tracker
    p7 = _pose7(cpu_slam, 1)
    (a, _), (b, _) = tr.frame_pose(p7), tr.frame_pose(p7)
    assert a["R"] is not b["R"] and tr.graph is None
    assert torch.equal(torch.cat([a["R"], a["T"]]), p7)


def test_graph_counters_and_spans_are_declared_at_construction(cpu_slam):
    it = cpu_slam.iters_run
    for span in ("track.draw", "track.replay", "track.capture"):
        assert span in profiling.SPANS and "us." + span in it
    assert "track_graph" in it and "graph_captures" in it
    # on the CPU the iterations run eagerly
    assert it["track_graph"] == it["graph_captures"] == 0


def test_count_adds_to_the_installed_registry():
    reg = {"track_graph": 0}
    profiling.count("track_graph")
    with profiling.installed(None, reg):
        profiling.count("track_graph", 3)
        with pytest.raises(KeyError):
            profiling.count("undeclared")
    profiling.count("track_graph")
    assert reg == {"track_graph": 3}


def test_track_graph_share_reader():
    from slambench import lib

    read = lib.load_module("metrics", "track_graph_share").read
    it = {"track": 80, "map": 40, "track_graph": 78}
    assert read({"stats": {"frames": 10, "iters": it}}) == 78 / 80
    # no tracing, a parent without the counter, no tracking iterations
    assert read({}) is None
    assert read({"stats": {"frames": 10,
                           "iters": {"track": 80, "map": 40}}}) is None
    assert read({"stats": {"frames": 10,
                           "iters": dict(it, track=0)}}) is None


def test_benchmark_declares_track_graph_share():
    from slambench import lib

    m = {m["name"]: m for m in lib.benchmark()["per_layer"]}[
        "track_graph_share"]
    assert m["layer"] == "tracker" and m["source"] == "program_counter"
    assert m["moves"] == "frames_per_s" and "workloads" not in m


# -- on the card ------------------------------------------------------------

CARD = {"tracking": {"pixels": 800, "iters": 8, "ignore_edge_W": 6,
                     "ignore_edge_H": 6},
        "mapping": {"pixels": 1000, "iters": 5, "iters_first": 10,
                    "every_frame": 2, "keyframe_every": 2}}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_track_graph.py")


@pytest.fixture(scope="module", params=["hash", "hash_fixed_beta", "brick",
                                        "brick_lowp"])
def card_slam(request):
    """A slam on the card that has tracked frame 1 (the driver's graph is
    captured) and mapped frames 0 and 2."""
    _card()
    slam = _slam("cuda", request.param, size=(96, 128), frames=6,
                 overrides=CARD)
    for idx in (1, 2):
        slam.step_frame(idx)
    # the tracker's capture, and the mapper's where it maps on a graph
    it = slam.iters_run
    assert it["graph_captures"] == 1 + (it["map_graph"] > 0)
    assert it["track_graph"] == it["track"] - 1
    yield slam
    slam.close()


def _eager(slam, p7):
    """Fresh leaves and torch's Adam: `step` runs them eagerly."""
    pose = tracker_lib.make_pose(p7)
    return pose, tracker_lib.make_optimizer(slam.tc, pose)


def _grads(pose):
    return {k: v.grad.clone() for k, v in pose.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("handed", [False, True], ids=["drawn", "handed"])
def test_graphed_first_iteration_is_the_eager_one(card_slam, handed):
    """Iteration 0 replayed from the graph: the eager step's loss,
    uncertainty and (R, T) gradients, bitwise; handed-in draws are the
    ones taken."""
    slam = card_slam
    tr = slam.tracker
    depth, color = _frame(slam, 3)
    p7 = _pose7(slam, 3)
    gen = rng.generator(21, slam.device)
    draws = dict(tr.draw_pixels(gen), t_depth=torch.rand(
        slam.tc.pixels, slam.rc_track.n_stratified
        + slam.rc_track.n_importance, generator=gen,
        device=slam.device)) if handed else None
    out = {}
    for name, (pose, opt) in (("eager", _eager(slam, p7)),
                              ("graph", tr.frame_pose(p7))):
        loss, unc = tr.step(slam.params, pose, opt, depth, color,
                            rng.generator(33, slam.device), draws)
        out[name] = (loss, unc, tr.last_median.clone(), _grads(pose))
    assert tr.graph.graph is not None
    (le, ue, me, ge), (lg, ug, mg, gg) = out["eager"], out["graph"]
    assert torch.equal(le, lg) and torch.equal(ue, ug)
    assert torch.equal(me, mg)
    for k in ("R", "T"):
        assert torch.equal(ge[k], gg[k]), k
    if handed:
        for k in ("i", "j"):
            assert torch.equal(tr.graph.pixels[k], draws[k])
        assert torch.equal(tr.graph.render["t_depth"], draws["t_depth"])


@pytest.mark.cuda
def test_graphed_frame_is_the_eager_frame(card_slam):
    """A frame of `iters` iterations, then doubled through `carry` /
    `iter0`, replayed from the graph: the eager loop's best pose, minimum
    loss and uncertainty carry and stepped leaves, bitwise, and the same
    `build.LAUNCHES`."""
    from unislam_tpu_torch.kernels import build

    slam = card_slam
    tr, n = slam.tracker, slam.tc.iters
    depth, color = _frame(slam, 3)
    p7 = _pose7(slam, 3)
    res, launches = {}, {}
    for name, (pose, opt) in (("eager", _eager(slam, p7)),
                              ("graph", tr.frame_pose(p7))):
        before = build.LAUNCHES.copy()
        st = tr.track_frame(slam.params, pose, opt, depth, color, 9, n)
        st = tr.track_frame(slam.params, pose, opt, depth, color, 9, n,
                            iter0=n, carry=st)
        torch.cuda.synchronize()
        launches[name] = build.LAUNCHES - before
        res[name] = (st, torch.cat([pose["R"], pose["T"]]).detach())
    for a, b in zip(res["eager"][0], res["graph"][0]):
        assert torch.equal(a, b)
    assert torch.equal(res["eager"][1], res["graph"][1])
    assert launches["eager"] == launches["graph"]
    assert sum(launches["graph"].values()) > 0


@pytest.mark.cuda
def test_new_scene_storage_recaptures_once(card_slam):
    """A scene in new storage, as the overlapped driver's snapshot brings:
    one eager warm-up, one capture (counted in `graph_captures`), then
    replays; the numbers are the eager loop's on that scene. Back on the
    first storage it captures once more."""
    slam = card_slam
    tr, n = slam.tracker, 6
    depth, color = _frame(slam, 3)
    p7 = _pose7(slam, 3)
    snap = {k: (copy.deepcopy(v) if isinstance(v, dict) else v.clone())
            for k, v in slam.params.items()}
    reg = {"track_graph": 0, "graph_captures": 0}
    with profiling.installed(None, reg):
        graphed = tr.track_frame(snap, *tr.frame_pose(p7), depth, color,
                                 4, n)
    assert reg == {"track_graph": n - 1, "graph_captures": 1}
    eager = tr.track_frame(snap, *_eager(slam, p7), depth,
                           color, 4, n)
    for a, b in zip(eager, graphed):
        assert torch.equal(a, b)
    with profiling.installed(None, reg):
        tr.track_frame(slam.params, *tr.frame_pose(p7), depth, color, 4, n)
    assert reg == {"track_graph": 2 * (n - 1), "graph_captures": 2}
