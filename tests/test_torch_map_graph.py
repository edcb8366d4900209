"""The mapper's graphed iteration (`unislam_tpu_torch/engine/mapper.py`:
`MapGraph`, `Mapper.phase_leaves`) and the graph pieces it shares with the
tracker (`unislam_tpu_torch/engine/graphs.py`: `GraphAdam`).

On the CPU, where the mapper runs its eager loop, the graph's parts run
eagerly: the draws it takes into its buffers are the draws `loss_fn`
takes from the same generator, its iteration (`MapGraph.run`) is the
eager step bit for bit, the leaves handed out again for each phase give
the numbers of fresh ones, and `GraphAdam` is torch's Adam.

On the card (marked `cuda`, skipped without a CUDA device), a mapping
phase replayed from the graph against the eager phase on fresh leaves and
torch's Adam, bit for bit, on the hash configuration (also with a fixed
beta), with and without the no-depth probe:

    python -m pytest --noconftest -m cuda tests/test_torch_map_graph.py

(this file imports no JAX, so it runs without the test configuration).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if p not in sys.path:
        sys.path.insert(0, p)

from test_torch_track_graph import CARD, _frame, _slam  # noqa: E402

from unislam_tpu_torch.core import pose as pose_lib  # noqa: E402
from unislam_tpu_torch.core import rng  # noqa: E402
from unislam_tpu_torch.engine import mapper as mapper_lib  # noqa: E402
from unislam_tpu_torch.engine import selection  # noqa: E402
from unislam_tpu_torch.engine.graphs import GraphAdam  # noqa: E402
from unislam_tpu_torch.utils import profiling  # noqa: E402


def _batch(slam, idx, probe):
    """A mapping phase's batch at frame `idx` over the bank as it stands,
    as `map_frame` builds it; with `probe`, a block of the frame's depth
    zeroed (rays without depth)."""
    depth, color = _frame(slam, idx)
    if probe:
        depth = depth.clone()
        depth[2:8, 3:11] = 0.0
    count = slam.kf_count
    probs, extra = selection.window_probs(slam.max_kf, count,
                                          np.zeros(slam.max_kf, bool))
    mask = np.zeros((slam.max_kf + 1, 1), np.float32)
    mask[:count, 0] = 1.0
    mask[0, 0] = 0.0
    mask[slam.max_kf, 0] = 1.0
    dev = slam.device
    return mapper_lib.MapBatch(
        slam.bank, depth, color, slam.cam_rays_d,
        torch.as_tensor(probs, dtype=torch.float32, device=dev),
        torch.as_tensor(extra, dtype=torch.float32, device=dev),
        torch.as_tensor(mask, device=dev), probe)


def _poses7(slam, idx):
    """The bank's poses and frame `idx`'s (off its true pose)."""
    _, _, c2w = slam.dataset[idx]
    cur = pose_lib.matrix_to_cam_pose(
        torch.as_tensor(c2w, dtype=torch.float32)[None])[0]
    cur = cur + torch.tensor([0.002, -0.001, 0.0, 0.001, 0.01, -0.005, 0.004])
    return torch.cat([slam.bank.pose7, cur.to(slam.device)[None]])


def _n_rays(mapper):
    return mapper.mc.pixels + mapper.mc.extra_rays


def _snapshot(tree):
    return {k: (_snapshot(v) if isinstance(v, dict) else v.detach().clone())
            for k, v in tree.items()}


def _restore(slam, snap):
    with torch.no_grad():
        for (k, v), (_, s) in zip(_flat(slam.params), _flat(snap)):
            v.copy_(s)


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _grads(leaves):
    """Each leaf's gradient (None for a leaf the loss does not reach: a
    fixed beta)."""
    return {k: None if v.grad is None else v.grad.clone()
            for k, v in leaves.items()}


def _same(a, b):
    return (a is None and b is None) or (
        a is not None and b is not None and torch.equal(a, b))


def _fresh(slam, poses7, lr_scale):
    """Fresh leaves and torch's Adam: `Mapper.step` runs them eagerly."""
    scene, poses = mapper_lib.trainable(slam.params, poses7)
    return scene, poses, mapper_lib.make_optimizer(slam.mc, scene, poses,
                                                   lr_scale)


@pytest.fixture(scope="module")
def cpu_slam():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    slam = _slam("cpu", frames=6)
    for idx in (1, 2):
        slam.step_frame(idx)
    yield slam
    slam.close()
    torch.set_num_threads(threads)


# -- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("probe", [False, True], ids=["depth", "probe"])
@pytest.mark.parametrize("handed", [(), ("slot", "pix_b", "pix_c"),
                                    ("t_depth",), "all"],
                         ids=["none", "rays", "jitter", "all"])
def test_taken_draws_are_the_draws_loss_fn_takes(cpu_slam, handed, probe):
    """`take` fills the buffers with the rays `loss_fn` draws from the
    same generator (slots, bank pixels, current pixels, then the
    renderer's), or with the ones handed in, and gathers them as it does;
    the loss on the buffers is `loss_fn`'s, bitwise, and both leave the
    generator in the same state."""
    slam = cpu_slam
    mapper = slam.mapper
    batch = _batch(slam, 3, probe)
    scene, poses, _ = _fresh(slam, _poses7(slam, 3), 1.0)
    other = rng.generator(12)
    given = mapper.draw(batch, other)
    given.update(mapper_lib.renderer.draw(mapper.rc, _n_rays(mapper), probe,
                                          other, slam.device))
    keys = tuple(given) if handed == "all" else handed
    draws = {k: given[k] for k in keys}

    gen_a = rng.generator(11)
    loss_a = mapper.loss_fn(scene, poses, batch, gen_a, dict(draws) or None)
    graph = mapper_lib.MapGraph(mapper)
    graph.bind(slam.params, _poses7(slam, 3), 1.0)
    gen_b = rng.generator(11)
    graph.take(batch, gen_b, dict(draws) or None)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    if "slot" in draws:
        assert torch.equal(graph.slot, draws["slot"])
    for k, t in graph.draws_for(probe).items():
        if k in draws:
            assert torch.equal(t, draws[k]), k
    loss_b = mapper.ray_loss(scene, poses, graph.mask, graph.slot,
                             graph.gt_depth, graph.gt_color, graph.dir_cam,
                             probe, None, graph.draws_for(probe))
    assert torch.equal(loss_a, loss_b)


@pytest.mark.parametrize("probe", [False, True], ids=["depth", "probe"])
def test_graph_iteration_run_eagerly_is_the_eager_step(cpu_slam, probe):
    """Three iterations of `take` + `MapGraph.run` on the graph's leaves
    give the eager `Mapper.step`'s loss, gradients and stepped leaves
    (torch's Adam), bit for bit."""
    slam = cpu_slam
    mapper = slam.mapper
    batch = _batch(slam, 3, probe)
    start = _snapshot(slam.params)
    p7 = _poses7(slam, 3)
    res = {}
    for name in ("eager", "graph"):
        _restore(slam, start)
        if name == "eager":
            scene, poses, opt = _fresh(slam, p7, 2.0)
        else:
            graph = mapper_lib.MapGraph(mapper)
            scene, poses, opt = graph.bind(slam.params, p7, 2.0)
        losses = []
        for it in range(3):
            gen = rng.generator(rng.fold_in(7, it))
            if name == "eager":
                losses.append(mapper.step(scene, poses, opt, batch, gen))
            else:
                graph.take(batch, gen, None)
                losses.append(graph.run(scene, probe)[0])
        leaves = dict(_flat({**scene, "poses": poses}))
        res[name] = (losses, {k: v.detach().clone()
                              for k, v in leaves.items()},
                     _grads(leaves))
    _restore(slam, start)
    (le, pe, ge), (lg, pg, gg) = res["eager"], res["graph"]
    for a, b in zip(le, lg):
        assert torch.equal(a, b)
    for k in pe:
        assert torch.equal(pe[k], pg[k]), k
        assert _same(ge[k], gg[k]), k


def test_bound_leaves_give_the_numbers_of_fresh_ones(cpu_slam):
    """Two phases (the first at the first phase's learning-rate factor) on
    the leaves `bind` hands out again, with their Adam restarted, give
    the numbers of fresh `trainable` leaves and torch's Adam, bit for
    bit; the leaves share the scene's storage, and a scene in new storage
    gets new ones."""
    slam = cpu_slam
    mapper = slam.mapper
    start = _snapshot(slam.params)
    out = {}
    for name in ("eager", "graph"):
        _restore(slam, start)
        graph = mapper_lib.MapGraph(mapper)
        for phase, (idx, scale) in enumerate(((3, 5.0), (4, 1.0))):
            batch = _batch(slam, idx, phase == 1)
            p7 = _poses7(slam, idx)
            if name == "eager":
                scene, poses, opt = _fresh(slam, p7, scale)
            else:
                scene, poses, opt = graph.bind(slam.params, p7, scale)
                assert graph.generation == 1
                for (_, a), (_, b) in zip(_flat(scene), _flat(slam.params)):
                    assert a.data_ptr() == b.data_ptr() and a.requires_grad
            for it in range(3):
                gen = rng.generator(rng.fold_in(phase, it))
                if name == "eager":
                    mapper.step(scene, poses, opt, batch, gen)
                else:
                    graph.take(batch, gen, None)
                    graph.run(scene, batch.probe)
            out.setdefault(name, []).append(
                (_snapshot(slam.params), poses.detach().clone()))
        if name == "graph":
            copy = _snapshot(slam.params)
            scene, _, _ = graph.bind(copy, _poses7(slam, 4), 1.0)
            assert graph.generation == 2
            assert next(_flat(scene))[1].data_ptr() == \
                next(_flat(copy))[1].data_ptr()
    _restore(slam, start)
    for (se, pe), (sg, pg) in zip(out["eager"], out["graph"]):
        assert torch.equal(pe, pg)
        for (k, a), (_, b) in zip(_flat(se), _flat(sg)):
            assert torch.equal(a, b), k


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_graph_adam_is_torch_adam(device):
    """`GraphAdam` against torch's Adam over 40 steps in three groups of
    gradients from 1e-9 to 1e3, past its table's steps, with a leaf that
    gets no gradient, then restarted at other learning rates: bit for
    bit."""
    if device == "cuda":
        _card()
    g = torch.Generator().manual_seed(3)
    shapes = [(5, 2), (3,), (7,), (4, 3)]
    groups = [0, 0, 1, 2]
    start = [torch.randn(s, generator=g) for s in shapes]
    leaves = [t.to(device).requires_grad_(True) for t in start]
    adam = GraphAdam(leaves, groups, (1e-3, 0.05, 0.01), (0.9, 0.999), 12)
    for lrs in ((1e-3, 0.05, 0.01), (5e-3, 0.25, 0.01)):
        adam.restart(lrs)
        ref = [t.detach().clone().requires_grad_(True) for t in leaves]
        ref_opt = torch.optim.Adam(
            [{"params": [ref[k] for k in range(4) if groups[k] == i],
              "lr": lr} for i, lr in enumerate(lrs)])
        for t in range(40):
            for k, (p, r) in enumerate(zip(leaves, ref)):
                if k == 1:
                    p.grad = r.grad = None
                    continue
                grad = (torch.randn(p.shape, generator=g)
                        * 10.0 ** torch.randint(-9, 4, p.shape, generator=g))
                p.grad, r.grad = grad.to(device), grad.to(device).clone()
            adam.step()
            ref_opt.step()
            for k in range(4):
                assert torch.equal(leaves[k], ref[k]), (lrs, t, k)


def test_the_cpu_gets_fresh_leaves_and_no_graph(cpu_slam):
    """Off a CUDA device `phase_leaves` hands out fresh leaves and torch's
    Adam each phase and `step` runs the eager loop; nor does the
    brick encoding, the fused decoders or the bf16 Adam state graph."""
    mapper = cpu_slam.mapper
    p7 = _poses7(cpu_slam, 3)
    (a, pa, oa), (b, pb, ob) = (mapper.phase_leaves(cpu_slam.params, p7, 1.0)
                                for _ in range(2))
    assert not mapper.graphed and mapper.graph is None
    assert pa is not pb and isinstance(oa, torch.optim.Adam)
    assert torch.equal(pa, p7)
    for over in ({"encoding": "brick"}, {"mlp_variant": "fused"}):
        m = mapper_lib.Mapper(dataclasses.replace(mapper.sc, **over), mapper.rc,
                              mapper.mc, mapper.intr, mapper.max_kf,
                              mapper.bank_size, "cpu")
        m.device = torch.device("cuda")
        assert not m.graphed
    m = mapper_lib.Mapper(mapper.sc, mapper.rc,
                          mapper.mc._replace(adam_state_dtype="bfloat16"),
                          mapper.intr, mapper.max_kf, mapper.bank_size, "cpu")
    m.device = torch.device("cuda")
    assert not m.graphed
    m.mc = mapper.mc
    assert m.graphed


def test_graph_counters_and_spans_are_declared_at_construction(cpu_slam):
    it = cpu_slam.iters_run
    for span in ("map.draw", "map.replay", "map.capture"):
        assert span in profiling.SPANS and "us." + span in it
        assert span in profiling.GRAPH_PARTS
    assert "map_graph" in it and "graph_captures" in it
    # on the CPU the iterations run eagerly
    assert it["map_graph"] == it["graph_captures"] == 0


# -- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_map_graph.py")


@pytest.fixture(scope="module", params=["hash", "hash_fixed_beta"])
def card_slam(request):
    """A slam on the card that has mapped frames 0 and 2 (its
    mapping graph is captured) and tracked frame 1."""
    _card()
    slam = _slam("cuda", request.param, size=(96, 128), frames=6,
                 overrides=CARD)
    for idx in (1, 2):
        slam.step_frame(idx)
    it = slam.iters_run
    assert it["map_graph"] == it["map"] - 1
    assert it["graph_captures"] == 2      # the tracker's and the mapper's
    yield slam
    slam.close()


@pytest.mark.cuda
@pytest.mark.parametrize("probe", [False, True], ids=["depth", "probe"])
def test_graphed_phase_is_the_eager_phase(card_slam, probe):
    """A phase of 6 iterations replayed from the graph (with the probe:
    after a new capture) against the eager phase on fresh leaves and
    torch's Adam: each iteration's loss, the stepped scene and poses and
    the last gradients, bitwise, and the same `build.LAUNCHES`."""
    from unislam_tpu_torch.kernels import build

    slam = card_slam
    mapper = slam.mapper
    batch = _batch(slam, 3, probe)
    start = _snapshot(slam.params)
    p7 = _poses7(slam, 3)
    res, launches = {}, {}
    for name in ("eager", "graph"):
        _restore(slam, start)
        if name == "eager":
            scene, poses, opt = _fresh(slam, p7, 1.0)
        else:
            scene, poses, opt = mapper.phase_leaves(slam.params, p7, 1.0)
            assert opt is mapper.graph.adam
        before = build.LAUNCHES.copy()
        losses = [mapper.step(scene, poses, opt, batch,
                              rng.generator(rng.fold_in(5, it), slam.device))
                  for it in range(6)]
        torch.cuda.synchronize()
        launches[name] = build.LAUNCHES - before
        leaves = dict(_flat({**scene, "poses": poses}))
        res[name] = (torch.stack(losses),
                     {k: v.detach().clone() for k, v in leaves.items()},
                     _grads(leaves))
    _restore(slam, start)
    (le, pe, ge), (lg, pg, gg) = res["eager"], res["graph"]
    assert torch.equal(le, lg)
    for k in pe:
        assert torch.equal(pe[k], pg[k]), k
        assert _same(ge[k], gg[k]), k
    assert launches["eager"] == launches["graph"]
    assert sum(launches["graph"].values()) > 0


@pytest.mark.cuda
def test_handed_draws_reach_the_graph(card_slam):
    """Iteration 0 with every draw handed in, as the benchmark's check
    hands them: the eager step's loss and gradients, bitwise."""
    slam = card_slam
    mapper = slam.mapper
    batch = _batch(slam, 3, True)
    gen = rng.generator(21, slam.device)
    draws = mapper.draw(batch, gen)
    draws.update(mapper_lib.renderer.draw(mapper.rc, _n_rays(mapper), True,
                                          gen, slam.device))
    start = _snapshot(slam.params)
    p7 = _poses7(slam, 3)
    res = {}
    for name in ("eager", "graph"):
        _restore(slam, start)
        scene, poses, opt = (_fresh(slam, p7, 1.0) if name == "eager"
                             else mapper.phase_leaves(slam.params, p7, 1.0))
        loss = mapper.step(scene, poses, opt, batch,
                           rng.generator(33, slam.device), draws)
        leaves = dict(_flat({**scene, "poses": poses}))
        res[name] = (loss, _grads(leaves))
    _restore(slam, start)
    assert torch.equal(res["eager"][0], res["graph"][0])
    for k, g in res["eager"][1].items():
        assert _same(g, res["graph"][1][k]), k
    for k, t in mapper.graph.draws_for(True).items():
        assert torch.equal(t, draws[k]), k
    assert torch.equal(mapper.graph.slot, draws["slot"])


def test_map_graph_share_reader():
    from slambench import lib

    read = lib.load_module("metrics", "map_graph_share").read
    it = {"track": 80, "map": 40, "map_graph": 39}
    assert read({"stats": {"frames": 10, "iters": it}}) == 39 / 40
    # no tracing, a parent without the counter, no mapping iterations
    assert read({}) is None
    assert read({"stats": {"frames": 10,
                           "iters": {"track": 80, "map": 40}}}) is None
    assert read({"stats": {"frames": 10, "iters": dict(it, map=0)}}) is None


def test_benchmark_declares_map_graph_share():
    from slambench import lib

    m = {m["name"]: m for m in lib.benchmark()["per_layer"]}[
        "map_graph_share"]
    assert m["layer"] == "mapper" and m["source"] == "program_counter"
    assert m["moves"] == "frames_per_s" and "workloads" not in m
