"""Port parity for the SLAM engine of `unislam_tpu_torch` against the JAX
package: one tracking step and one mapping step in lockstep (loss,
gradients, Adam-updated parameters and poses) on parameters carried across
with `params_from_jax` and the JAX run's own draws; the Adam step against
optax; the 8 + 8 = 16 tracking continuation; keyframes, window selection,
the constant-speed pose init and the ATE.

Tolerances: losses rtol 1e-5; gradients rtol 1e-4 plus 1e-5 of the leaf's
largest magnitude (f32 sums over every ray, taken in another order); an
Adam step's update within 1e-3 of its learning rate where the gradient is
above 1e-3 of the leaf's largest (below that, Adam's g / (|g| + eps) turns
the gradients' round-off into O(1) changes of the step, so those entries are
only held to |update| <= learning rate).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unislam_tpu.core import pose as jpose
from unislam_tpu.core.rays import Intrinsics as JIntr
from unislam_tpu.engine import keyframes as jkf
from unislam_tpu.engine import mapper as jmapper
from unislam_tpu.engine import selection as jsel
from unislam_tpu.engine import slam as jslam
from unislam_tpu.engine import tracker as jtracker
from unislam_tpu.models import hash_encoding as jhe
from unislam_tpu.models import scene as jscene
from unislam_tpu.render import renderer as jrender
from unislam_tpu.tools import eval_ate as jate
from unislam_tpu_torch.core.rays import Intrinsics as TIntr
from unislam_tpu_torch.core.rays import camera_ray_dirs
from unislam_tpu_torch.data.synthetic import SyntheticRoom
from unislam_tpu_torch.engine import keyframes as tkf
from unislam_tpu_torch.engine import mapper as tmapper
from unislam_tpu_torch.engine import selection as tsel
from unislam_tpu_torch.engine import slam as tslam
from unislam_tpu_torch.engine import tracker as ttracker
from unislam_tpu_torch.models import hash_encoding as the
from unislam_tpu_torch.models import scene as tscene
from unislam_tpu_torch.render import renderer as trender
from unislam_tpu_torch.tools import eval_ate as tate

INTR = dict(H=24, W=32, fx=30.0, fy=30.0, cx=15.5, cy=11.5)
SPEC = dict(n_levels=4, n_features=2, log2_hashmap_size=12,
            base_resolution=4, desired_resolution=64)
NS, NI = 10, 4
MAX_KF, BANK = 4, 100


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _grad_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    _close(a, b, rtol=1e-4, atol=1e-5 * max(np.abs(b).max(), 1e-12))


def _check_step(port_new, ref_new, old, ref_grad, lr):
    port_new, ref_new, old, g = (np.asarray(x, np.float64) for x in
                                 (port_new, ref_new, old, ref_grad))
    du_port, du_ref = port_new - old, ref_new - old
    assert (np.abs(du_port) <= lr * (1 + 1e-4) + 1e-7).all()
    big = np.abs(g) > 1e-3 * np.abs(g).max()
    np.testing.assert_allclose(du_port[big], du_ref[big], rtol=0,
                               atol=1e-3 * lr)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


class World:
    """A small scene: the synthetic room's frames, matching scene configs
    and JAX-initialised parameters with widened tables."""

    def __init__(self, seed=0, mlp_variant="vanilla"):
        self.ds = SyntheticRoom(n_frames=6, intr=TIntr(**INTR),
                                deg_per_frame=3.0)
        bound = np.asarray(self.ds.bound, np.float32)
        color = {**SPEC, "log2_hashmap_size": 11}
        self.jsc = jscene.SceneConfig(jhe.make_spec(**SPEC),
                                      jhe.make_spec(**color), bound, 0.1,
                                      mlp_variant=mlp_variant)
        self.tsc = tscene.SceneConfig(the.make_spec(**SPEC),
                                      the.make_spec(**color), bound, 0.1,
                                      mlp_variant=mlp_variant)
        tree = jax.tree_util.tree_map(
            np.asarray, jscene.init_params(jax.random.PRNGKey(seed),
                                           self.jsc))
        rng = np.random.default_rng(seed)
        for k in ("sdf_table", "color_table"):
            tree[k] = rng.uniform(-0.3, 0.3,
                                  tree[k].shape).astype(np.float32)
        self.tree = tree
        self.jrc = jrender.RenderConfig(n_stratified=NS, n_importance=NI)
        self.trc = trender.RenderConfig(n_stratified=NS, n_importance=NI)
        self.jintr, self.tintr = JIntr(**INTR), TIntr(**INTR)

    def frame(self, i):
        return self.ds[i]


def _render_draws(key, R):
    k_surf, k_uni, k_pdf = jax.random.split(key, 3)
    return {"t_depth": _t(jax.random.uniform(k_surf, (R, NS + NI))),
            "t_uni": _t(jax.random.uniform(k_uni, (R, NS))),
            "u_pdf": _t(jax.random.uniform(k_pdf, (R, NI)))}


# ---------------------------------------------------------------- tracking

TRACK = dict(pixels=64, iters=8, lr_T=0.01, lr_R=0.004, ignore_edge_W=2,
             ignore_edge_H=2)


def _pose7_near(c2w, seed):
    p7 = np.asarray(jpose.matrix_to_cam_pose(jnp.asarray(c2w)[None])[0])
    rng = np.random.default_rng(seed)
    return (p7 + rng.normal(scale=[0.01] * 4 + [0.02] * 3)).astype(
        np.float32)


def test_tracking_step_lockstep_with_jax():
    w = World()
    color, depth, c2w = w.frame(1)
    jtc = jtracker.TrackerConfig(**TRACK)
    ttc = ttracker.TrackerConfig(**TRACK)
    step, opt, _ = jtracker.make_tracking_step(w.jsc, w.jrc, jtc, w.jintr)
    loss_fn = inspect.getclosurevars(step.__wrapped__).nonlocals["loss_fn"]
    p7 = _pose7_near(c2w, 1)
    jpose_d = {"R": jnp.asarray(p7[:4]), "T": jnp.asarray(p7[4:])}
    key = jax.random.fold_in(jax.random.PRNGKey(11), 0)
    (jl, junc), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        jpose_d, w.tree, jnp.asarray(depth), jnp.asarray(color), key)
    jnew, _, jl2, _ = step(w.tree, jpose_d, opt.init(jpose_d),
                           jnp.asarray(depth), jnp.asarray(color), key)

    k_pix, k_render = jax.random.split(key)
    kj, ki = jax.random.split(k_pix)
    H, W = INTR["H"], INTR["W"]
    draws = {"j": _t(jax.random.randint(kj, (64,), 2, H - 2)),
             "i": _t(jax.random.randint(ki, (64,), 2, W - 2)),
             **_render_draws(k_render, 64)}
    tracker = ttracker.Tracker(w.tsc, w.trc, ttc, w.tintr, "cpu")
    pose = ttracker.make_pose(_t(p7))
    topt = ttracker.make_optimizer(ttc, pose)
    params = tscene.params_from_jax(w.tree, device="cpu")
    loss, unc = tracker.step(params, pose, topt, _t(depth), _t(color),
                             draws=draws)
    _close(loss, jl, rtol=1e-5)
    _close(jl2, jl, rtol=1e-6)
    _close(unc, junc, rtol=1e-5)
    _grad_close(pose["R"].grad, jg["R"])
    _grad_close(pose["T"].grad, jg["T"])
    _check_step(pose["R"].detach(), jnew["R"], p7[:4], jg["R"], TRACK["lr_R"])
    _check_step(pose["T"].detach(), jnew["T"], p7[4:], jg["T"], TRACK["lr_T"])
    assert all(v.grad is None for _, v in _leaves(params))


def test_tracking_continuation_equals_one_longer_call():
    """Draws of iteration i come from (frame seed, iter0 + i): 8 + 8
    chained iterations equal one 16-iteration call, bit for bit."""
    w = World()
    color, depth, c2w = w.frame(1)
    ttc = ttracker.TrackerConfig(**TRACK)
    tracker = ttracker.Tracker(w.tsc, w.trc, ttc, w.tintr, "cpu")
    params = tscene.params_from_jax(w.tree, device="cpu")
    p7 = _t(_pose7_near(c2w, 2))

    def fresh():
        pose = ttracker.make_pose(p7)
        return pose, ttracker.make_optimizer(ttc, pose)

    pose_a, opt_a = fresh()
    one = tracker.track_frame(params, pose_a, opt_a, _t(depth), _t(color),
                              seed=5, n_iters=16)
    pose_b, opt_b = fresh()
    half = tracker.track_frame(params, pose_b, opt_b, _t(depth), _t(color),
                               seed=5, n_iters=8)
    two = tracker.track_frame(params, pose_b, opt_b, _t(depth), _t(color),
                              seed=5, n_iters=8, iter0=8, carry=half)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    assert torch.equal(pose_a["R"], pose_b["R"])
    assert torch.equal(pose_a["T"], pose_b["T"])
    assert float(one.min_loss) < float("inf")


def test_adam_step_matches_optax():
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(50,)).astype(np.float32)
    grads = [rng.normal(size=(50,)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    for b1, lr in ((0.5, 0.004), (0.9, 0.05)):
        jopt = optax.adam(lr, b1=b1, b2=0.999)
        jx, state = jnp.asarray(x0), jopt.init(jnp.asarray(x0))
        tx = torch.tensor(x0, requires_grad=True)
        topt = torch.optim.Adam([tx], lr=lr, betas=(b1, 0.999))
        for g in grads:
            upd, state = jopt.update(jnp.asarray(g), state, jx)
            jx = optax.apply_updates(jx, upd)
            tx.grad = torch.tensor(g)
            topt.step()
            _close(tx.detach(), jx, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- mapping

MAP = dict(pixels=96, extra_rays=16, iters=5, lr_hash=0.05, lr_c_hash=0.05,
           lr_decoders=0.001, joint_opt_cam_lr=0.001)


def _bank(w, with_holes):
    """A bank of 3 keyframes from frames 0, 2, 4 (some depths zeroed when
    `with_holes`), with the JAX bank's own pixel permutations."""
    jbank = jkf.init_bank(MAX_KF, BANK)
    add = jkf.make_add_keyframe(INTR["H"], INTR["W"], BANK)
    tbank = tkf.init_bank(MAX_KF, BANK, device="cpu")
    dirs = np.asarray(camera_ray_dirs(w.tintr, device="cpu"))
    for n, f in enumerate((0, 2, 4)):
        color, depth, c2w = w.frame(f)
        if with_holes:
            depth = depth.copy()
            depth[:3] = 0.0
        key = jax.random.PRNGKey(100 + f)
        jbank = add(jbank, jnp.asarray(depth), jnp.asarray(color),
                    jnp.asarray(dirs), jnp.asarray(c2w), jnp.asarray(c2w),
                    jnp.int32(f), key)
        perm = _t(jax.random.permutation(key, INTR["H"] * INTR["W"]))
        tkf.add_keyframe(tbank, _t(depth), _t(color), _t(dirs), _t(c2w),
                         _t(c2w), f, perm=perm)
    return jbank, tbank, dirs


@pytest.mark.parametrize("with_holes", [False, True])
def test_mapping_step_lockstep_with_jax(with_holes):
    """One mapping step: loss, gradients of every scene leaf and of the
    poses (the BA mask freezing the oldest window slot), and the updated
    parameters. With holes in the depth, the no-depth probe runs."""
    _mapping_lockstep(with_holes, lowp=False)


def test_mapping_step_lowp_lockstep_with_jax(monkeypatch):
    """The same step with both low-precision options on (fused bf16
    decoders, bf16-state Adam for the tables), with holes in the depth so
    the probe runs the fused SDF head too."""
    _mapping_lockstep(True, lowp=True, monkeypatch=monkeypatch)


def bf16_grad_close(a, b, terms=None):
    """Gradients that pass bf16 rounding points (the fused decoders):
    within one bf16 step (2^-7) of the value, or, where `terms` (the sum
    of |terms| of each element) is given, of the terms, plus 1e-5 of the
    leaf's largest magnitude. The frameworks' f32 cotangents differ by
    round-off, which can move a bf16 rounding by one step."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b) if terms is None else np.asarray(terms, np.float64)
    assert (np.abs(a - b) <= 2.0 ** -7 * scale
            + 1e-5 * max(np.abs(b).max(), 1e-12)).all(), \
        float(np.abs(a - b).max())


def _record_scatter(monkeypatch, module):
    """Record the (destinations, rows) that `module`'s backward hands the
    scatter-accumulate."""
    calls = []
    real = module.scatter_accumulate

    def spy(idx, rows, n_rows):
        calls.append((idx, rows, n_rows))
        return real(idx, rows, n_rows)

    monkeypatch.setattr(module, "scatter_accumulate", spy)
    return calls


def _abs_terms(calls, n_rows):
    """Each table element's sum of |terms| over the recorded rows."""
    from unislam_tpu_torch.kernels.scatter_accum import \
        scatter_accumulate_plain
    return sum(scatter_accumulate_plain(idx, rows.abs(), n)
               for idx, rows, n in calls if n == n_rows).numpy()


def _mapping_lockstep(with_holes, lowp, monkeypatch=None):
    variant = "fused" if lowp else "vanilla"
    w = World(seed=3, mlp_variant=variant)
    jbank, tbank, dirs = _bank(w, with_holes)
    for name in ("depth", "color", "rays_d", "pose7", "frame_idx"):
        _close(getattr(tbank, name), getattr(jbank, name), rtol=0, atol=0)
    assert tbank.count == int(jbank.count) == 3

    color, depth, c2w = w.frame(5)
    dtype = "bfloat16" if lowp else "float32"
    jmc = jmapper.MapperConfig(**MAP, adam_state_dtype=dtype)
    tmc = tmapper.MapperConfig(**MAP, adam_state_dtype=dtype)
    probs = np.array([0.25, 0.25, 0.25, 0.0, 0.25])
    extra = probs
    mask = np.array([[0.0], [1.0], [1.0], [0.0], [1.0]], np.float32)
    cur7 = _pose7_near(c2w, 4)
    poses = np.concatenate([np.asarray(jbank.pose7), cur7[None]])
    lr_scale = 5.0
    args = (jbank, jnp.asarray(depth), jnp.asarray(color), jnp.asarray(dirs),
            jnp.asarray(probs, jnp.float32), jnp.asarray(extra, jnp.float32),
            jnp.asarray(mask))
    key = jax.random.fold_in(jax.random.PRNGKey(21), 0)
    loss_fn = jmapper.make_loss_fn(w.jsc, w.jrc, jmc, w.jintr, MAX_KF, BANK)
    tree = {"scene": w.tree, "poses": jnp.asarray(poses)}
    jl, jg = jax.value_and_grad(loss_fn)(tree, *args, key)
    step, opt, _ = jmapper.make_mapping_step(w.jsc, w.jrc, jmc, w.jintr,
                                             MAX_KF, BANK)
    jnew, jstate, _ = step(tree, opt.init(tree), *args, key,
                           jnp.float32(lr_scale))

    k_slot, k_extra, k_pix_b, k_pix_c, k_render = jax.random.split(key, 5)
    n = MAP["pixels"] + MAP["extra_rays"]
    draws = {
        "slot": _t(jnp.concatenate([
            jax.random.categorical(k_slot, jnp.log(args[4] + 1e-20),
                                   shape=(MAP["pixels"],)),
            jax.random.categorical(k_extra, jnp.log(args[5] + 1e-20),
                                   shape=(MAP["extra_rays"],))])),
        "pix_b": _t(jax.random.randint(k_pix_b, (n,), 0, BANK)),
        "pix_c": _t(jax.random.randint(k_pix_c, (n,), 0,
                                       INTR["H"] * INTR["W"])),
        **_render_draws(k_render, n)}

    mapper = tmapper.Mapper(w.tsc, w.trc, tmc, w.tintr, MAX_KF, BANK, "cpu")
    batch = tmapper.MapBatch(tbank, _t(depth), _t(color), _t(dirs),
                             _t(probs).float(), _t(extra).float(), _t(mask),
                             probe=with_holes)
    scene, tposes = tmapper.trainable(
        tscene.params_from_jax(w.tree, device="cpu"), _t(poses))
    topt = tmapper.make_optimizer(tmc, scene, tposes, lr_scale)
    calls = _record_scatter(monkeypatch, the) if lowp else None
    loss = mapper.step(scene, tposes, topt, batch, draws=draws)

    _close(loss, jl, rtol=1e-5)
    lrs = {"sdf_table": MAP["lr_hash"] * lr_scale,
           "color_table": MAP["lr_c_hash"] * lr_scale}
    ref_leaves = dict(_leaves(jg["scene"]))
    new_leaves = dict(_leaves(jnew["scene"]))
    for k, v in _leaves(scene):
        if not lowp:
            _grad_close(v.grad, ref_leaves[k])
        elif k in lrs:
            bf16_grad_close(v.grad, ref_leaves[k],
                            _abs_terms(calls, v.shape[0]))
        else:
            bf16_grad_close(v.grad, ref_leaves[k])
        _check_step(v.detach(), new_leaves[k], dict(_leaves(w.tree))[k],
                    ref_leaves[k],
                    lrs.get(k, MAP["lr_decoders"] * lr_scale))
    if lowp:
        # the tables' first moments: bf16 by stochastic rounding of
        # g * (1 - b1), within one bf16 step of JAX's
        for k, label in (("sdf_table", "hash"), ("color_table", "c_hash")):
            m = topt.opts[1].state[scene[k]]["m"]
            mu = np.asarray(jstate.inner_states[label].inner_state[0].mu[
                "scene"][k], np.float32)
            assert m.dtype == torch.bfloat16
            bf16_grad_close(m.float(), mu,
                            np.abs(mu) + 0.1 * _abs_terms(calls, m.shape[0]))
    _grad_close(tposes.grad, jg["poses"])
    assert (tposes.grad[mask[:, 0] == 0] == 0).all()
    _check_step(tposes.detach(), jnew["poses"], poses, jg["poses"],
                MAP["joint_opt_cam_lr"])


def test_mapper_config_rejects_low_precision_adam():
    """adam_state_dtype "bfloat16" and "float32" are taken, as by the JAX
    package; anything else (a typo such as "bf16") is refused with
    ValueError rather than run as float32."""
    m = {"pixels": 10, "iters": 2, "iters_first": 3, "every_frame": 4,
         "keyframe_every": 4, "mapping_window_size": 5,
         "lr": {"decoders_lr": 0.001, "hash_grids_lr": 0.05,
                "c_hash_grids_lr": 0.05},
         "w_sdf_fs": 5.0, "w_sdf_center": 200.0, "w_sdf_tail": 10.0,
         "w_depth": 0.1, "w_color": 5.0}
    assert tmapper.from_cfg({"mapping": m}).adam_state_dtype == "float32"
    for dtype in ("bfloat16", "float32"):
        mc = tmapper.from_cfg({"mapping": {**m, "adam_state_dtype": dtype}})
        jmc = jmapper.from_cfg({"mapping": {**m, "adam_state_dtype": dtype}})
        assert mc.adam_state_dtype == jmc.adam_state_dtype == dtype
    for bad in ("bf16", "float16"):
        cfg = {"mapping": {**m, "adam_state_dtype": bad}}
        with pytest.raises(ValueError):
            tmapper.from_cfg(cfg)
        with pytest.raises(ValueError):
            jmapper.make_optimizer(jmapper.from_cfg(cfg))


# ---------------------------------------------------------------- keyframes

def test_keyframe_eviction_compacts_like_jax():
    w = World()
    jbank, tbank, _ = _bank(w, False)
    for slot in (1, 0):
        jbank = jkf.make_evict_keyframe(MAX_KF)(jbank, jnp.int32(slot))
        tkf.evict_keyframe(tbank, slot)
        for name in ("depth", "color", "rays_d", "pose7", "gt_c2w",
                     "frame_idx"):
            _close(getattr(tbank, name), getattr(jbank, name), rtol=0,
                   atol=0)
        assert tbank.count == int(jbank.count)


# ---------------------------------------------------------------- selection

@pytest.mark.parametrize("frame", [3, 5])
def test_selection_matches_jax(frame):
    w = World()
    jbank, tbank, _ = _bank(w, False)
    color, depth, c2w = w.frame(frame)
    kw = dict(num_rays=50, num_samples=8, window_size=3, edge=2)
    jselect = jsel.make_selection_fn(w.jintr, MAX_KF, **kw)
    tselect = tsel.make_selection_fn(w.tintr, MAX_KF, **kw)
    key = jax.random.PRNGKey(frame)
    ref = jselect(jbank, jnp.asarray(depth), jnp.asarray(color),
                  jnp.asarray(c2w), frame, key)
    kj, ki = jax.random.split(key)
    ij = (_t(jax.random.randint(ki, (50,), 0, INTR["W"])),
          _t(jax.random.randint(kj, (50,), 0, INTR["H"])))
    out = tselect(tbank, _t(depth), _t(color), _t(c2w), frame, ij=ij)
    _close(out.percent_inside, ref.percent_inside, rtol=0, atol=1e-6)
    for name in ("normal_mask", "lc_mask", "lc_flag", "back_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(out, name)),
                                      np.asarray(getattr(ref, name)))


@pytest.mark.parametrize("count", [0, 1, 2, 5, 25])
def test_window_probs_match_jax(count):
    mask = np.zeros(30, bool)
    mask[:max(count - 2, 0):2] = True
    for a, b in zip(tsel.window_probs(30, count, mask),
                    jsel.window_probs(30, count, mask)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- driver

def test_const_speed_init_and_intrinsics_match_jax():
    w = World()
    a, b = w.ds.gt_pose(1), w.ds.gt_pose(2)
    _close(ttracker.init_pose_const_speed(_t(b), _t(a)),
           jtracker.init_pose_const_speed(jnp.asarray(b), jnp.asarray(a)),
           rtol=1e-5, atol=1e-6)
    cam = {"H": 680, "W": 1200, "fx": 600.0, "fy": 610.0, "cx": 599.5,
           "cy": 339.5}
    for extra in ({}, {"crop_edge": 10}, {"crop_size": [340, 600]}):
        cfg = {"cam": {**cam, **extra}}
        assert tuple(tslam.intrinsics_from_cfg(cfg)) == \
            tuple(jslam.intrinsics_from_cfg(cfg))


def test_pose_evaluation_matches_jax():
    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4, dtype=np.float32), (20, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(scale=0.05, size=(20, 3)), axis=0)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(scale=0.01, size=(20, 3))
    _, ref = jate.pose_evaluation(gt, est)
    _, out = tate.pose_evaluation(gt, est)
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k] == ref[k]
