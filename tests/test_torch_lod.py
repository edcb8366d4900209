"""Port parity for the brick-encoding scene and its surface-LOD queries
(`unislam_tpu_torch.models.scene`), the LOD branches of `render_rays`, and
one tracking and one mapping step on a brick configuration, against the
JAX package on the same parameters (carried across with `params_from_jax`)
and the JAX run's own draws. Then the port alone drives the synthetic room
with the brick settings of `examples/run_synthetic_slam.py --encoding brick`
to ATE-RMSE < 3 cm.

The ladder (3 levels, F = 8) mirrors `configs/Replica/room0_tpu.yaml` at a
small size: a dense level (the JAX package's one-hot level), then two hashed
levels of 512 and 1024 rows. Mapping splits it "cost" (coarse (0,), fine
(1, 2)), tracking "coarse2" (coarse (0, 1), fine (2,)).

Tolerances as in `tests/test_torch_engine.py`: values rtol 1e-5 / atol 1e-6
(renders rtol 1e-4 / atol 1e-5); gradients rtol 1e-4 plus 1e-5 of the
leaf's largest magnitude (f32 sums over every sample, taken in another
order); Adam steps within 1e-3 of the learning rate where the gradient is
above 1e-3 of the leaf's largest.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import (BANK, INTR, MAP, MAX_KF, NI, NS, TRACK, World,
                               _bank, _check_step, _close, _grad_close,
                               _leaves, _pose7_near, _render_draws, _t)
from test_torch_slam_drive import _drive_config
from unislam_tpu.engine import mapper as jmapper
from unislam_tpu.engine import tracker as jtracker
from unislam_tpu.models import brick_encoding as jbe
from unislam_tpu.models import scene as jscene
from unislam_tpu.render import renderer as jrender
from unislam_tpu_torch.engine import mapper as tmapper
from unislam_tpu_torch.engine import tracker as ttracker
from unislam_tpu_torch.kernels import scatter_accum as tsa
from unislam_tpu_torch.models import brick_encoding as tbe
from unislam_tpu_torch.models import scene as tscene
from unislam_tpu_torch.render import renderer as trender

LADDER = dict(n_levels=3, n_features=8, log2_hashmap_size=10,
              base_resolution=8, desired_resolution=64, matmul_max_rows=64,
              hashed_level_rows=[512, 1024])
N_FINE = 5


class BrickWorld(World):
    """The engine tests' small world with a brick scene: JAX-initialised
    parameters whose table is widened from the +-1e-4 init."""

    def __init__(self, seed=0, **lod):
        super().__init__(seed)
        self.jsc = dataclasses.replace(self.jsc, encoding="brick",
                                       brick_spec=jbe.make_spec(**LADDER))
        self.tsc = dataclasses.replace(self.tsc, encoding="brick",
                                       brick_spec=tbe.make_spec(**LADDER))
        tree = jax.tree_util.tree_map(
            np.asarray, jscene.init_params(jax.random.PRNGKey(seed),
                                           self.jsc))
        tree["table"] = np.random.default_rng(seed).uniform(
            -0.3, 0.3, tree["table"].shape).astype(np.float32)
        self.tree = tree
        lod = {"n_fine": N_FINE, **lod}
        self.jrc = self.jrc._replace(**lod)
        self.trc = self.trc._replace(**lod)


def _trainable(tree):
    params = tscene.params_from_jax(tree, device="cpu")
    for _, v in _leaves(params):
        v.requires_grad_(True)
    return params


def _record_table_rows(monkeypatch):
    """Record the (destinations, rows) that the brick backward hands the
    scatter-accumulate, one entry per encode_multi backward."""
    calls = []
    real = tbe.scatter_accumulate

    def spy(idx, rows, n_rows):
        calls.append((idx, rows))
        return real(idx, rows, n_rows)

    monkeypatch.setattr(tbe, "scatter_accumulate", spy)
    return calls


def _table_tol(calls, spec):
    """2^-7 of each table element's sum of |terms|: a term is
    bf16(bf16(w) * bf16(g)), and the cotangent g reaching the encoder
    differs between the frameworks by f32 round-off, which can move bf16(g)
    and then the product's rounding by one bf16 step (2^-8) each."""
    abs_sum = sum(tsa.scatter_accumulate_plain(idx, rows.abs(),
                                               spec.total_rows * 27)
                  for idx, rows in calls)
    return 2.0 ** -7 * abs_sum.view(spec.total_rows, -1).numpy()


def _check_tree_grads(params, jg_tree, table_tol):
    """Every leaf's gradient against JAX's (the table within `table_tol`
    plus the usual 1e-5 of its largest); a leaf the function does not read
    (beta in a query, the color head in raw_sdf) gets none, where JAX gives
    zeros."""
    ref = dict(_leaves(jg_tree))
    for k, v in _leaves(params):
        if v.grad is None:
            assert not np.any(ref[k]), k
        elif k == "table":
            err = np.abs(v.grad.numpy() - ref[k])
            assert (err <= table_tol
                    + 1e-5 * np.abs(ref[k]).max()).all(), err.max()
        else:
            _grad_close(v.grad, ref[k])


# ---------------------------------------------------------------- queries

def _selection(R, S, K, seed):
    """Distinct sample indices per ray, as top_k gives them."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(S)[:K] for _ in range(R)]).astype(
        np.int32)


@pytest.mark.parametrize("query", ["lod", "lod_mid", "lod_field", "coarse",
                                   "raw_sdf_levels", "query"])
def test_brick_queries_match_jax(query, monkeypatch):
    """Values and gradients (every parameter leaf and the points) of the
    brick queries on the same points and selections."""
    w = BrickWorld(seed=1)
    jsc, tsc = w.jsc, w.tsc
    R, S, K = 24, 14, N_FINE
    rng = np.random.default_rng(2)
    p = rng.uniform(-0.05, 1.05, (R, S, 3)).astype(np.float32)
    sel = _selection(R, S, K, 3)
    onehot = jnp.asarray(sel[..., None] == np.arange(S)[None, None, :])
    out_dim = 1 if query == "raw_sdf_levels" else 4
    shape = (R * S,) if out_dim == 1 else (R * S, 4)
    flat = query in ("coarse", "raw_sdf_levels", "query")
    if not flat:
        shape = (R, S, 4)
    g = rng.normal(size=shape).astype(np.float32)

    def jfn(prm, x):
        if query == "lod":
            return jscene.query_lod(prm, jsc, x, onehot)
        if query == "lod_mid":
            return jscene.query_lod(prm, jsc, x, onehot, split="hashed",
                                    n_mid=2)
        if query == "lod_field":
            return jscene.query_lod_field(prm, jsc, x, K, split="coarse2")
        x = x.reshape(-1, 3)
        if query == "coarse":
            return jscene.query_coarse(prm, jsc, x, split="coarse2")
        if query == "raw_sdf_levels":
            return jscene.raw_sdf(prm, jsc, x, levels=(0, 1))
        return jscene.query(prm, jsc, x)

    def tfn(prm, x):
        if query == "lod":
            return tscene.query_lod(prm, tsc, x, torch.tensor(sel).long())
        if query == "lod_mid":
            return tscene.query_lod(prm, tsc, x, torch.tensor(sel).long(),
                                    split="hashed", n_mid=2)
        if query == "lod_field":
            return tscene.query_lod_field(prm, tsc, x, K, split="coarse2")
        x = x.reshape(-1, 3)
        if query == "coarse":
            return tscene.query_coarse(prm, tsc, x, split="coarse2")
        if query == "raw_sdf_levels":
            return tscene.raw_sdf(prm, tsc, x, levels=(0, 1))
        return tscene.query(prm, tsc, x)

    ref, (jg_tree, jg_p) = jax.jit(
        lambda prm, x: (lambda o, vjp: (o, vjp(jnp.asarray(g))))(
            *jax.vjp(jfn, prm, x)))(w.tree, jnp.asarray(p))
    params = _trainable(w.tree)
    tp = torch.tensor(p, requires_grad=True)
    calls = _record_table_rows(monkeypatch)
    out = tfn(params, tp)
    out.backward(torch.tensor(g))
    _close(out.detach(), ref)
    _grad_close(tp.grad, jg_p)
    _check_tree_grads(params, jg_tree, _table_tol(calls, tsc.brick_spec))
    assert params["beta"].grad is None
    assert (params["color_mlp"]["w0"].grad is None) == \
        (query == "raw_sdf_levels")


def test_zero_fill_and_split_guards():
    w = BrickWorld()
    feat = torch.arange(2 * 16, dtype=torch.float32).view(2, 16)
    full = tscene._zero_fill_levels(feat, w.tsc.brick_spec, (0, 2))
    ref = jscene._zero_fill_levels(jnp.asarray(feat.numpy()),
                                   w.jsc.brick_spec, (0, 2))
    np.testing.assert_array_equal(full.numpy(), np.asarray(ref))
    sel = torch.zeros(3, 2, dtype=torch.long)
    with pytest.raises(NotImplementedError):
        tscene.query_lod(_trainable(w.tree), w.tsc, torch.rand(3, 4, 3), sel,
                         dedup=0.5)
    score = torch.tensor([[0.5, 1.0, 1.0, 0.2, 1.0]])
    _, jidx = jax.lax.top_k(jnp.asarray(score.numpy()), 3)
    np.testing.assert_array_equal(tscene.top_k_indices(score, 3).numpy(),
                                  np.asarray(jidx))


# ---------------------------------------------------------------- renderer

def _rays(R, seed, no_depth):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    gd = rng.uniform(0.3, 0.9, R).astype(np.float32)
    gd[:no_depth] = 0.0
    return o, d, gd


@pytest.mark.parametrize("lod,no_depth", [
    (dict(), 0),
    (dict(n_fine_mid=2, lod_split="hashed"), 9),
    (dict(lod_select="field", lod_split="coarse2"), 0),
    (dict(n_fine=-1, lod_split="coarse2"), 9),
])
def test_lod_render_rays_matches_jax(lod, no_depth, monkeypatch):
    """The LOD branches of render_rays on the JAX run's draws: the depth
    band, the band with a narrower mid band and rays without depth (the
    probe reads only the coarse levels, and its depth places the band),
    the field-guided band, and the coarse-only query."""
    w = BrickWorld(seed=5, **lod)
    R, S = 40, NS + NI
    o, d, gd = _rays(R, 6, no_depth)
    key = jax.random.PRNGKey(7)
    draws = _render_draws(key, R)
    cot = np.random.default_rng(8)
    w_rgb = cot.normal(size=(R, 3)).astype(np.float32)
    w_d = cot.normal(size=R).astype(np.float32)
    w_s = cot.normal(size=(R, S)).astype(np.float32)

    def jloss(prm, o, d):
        out = jrender.render_rays(prm, w.jsc, w.jrc, o, d, jnp.asarray(gd),
                                  key)
        return out, (jnp.sum(out.rgb * w_rgb) + jnp.sum(out.depth * w_d)
                     + jnp.sum(out.sdf * w_s) + jnp.sum(out.depth_std))

    (_, ref), (jg_tree, jg_o, jg_d) = jax.jit(jax.value_and_grad(
        lambda *a: jloss(*a)[::-1], argnums=(0, 1, 2), has_aux=True))(
        w.tree, jnp.asarray(o), jnp.asarray(d))

    params = _trainable(w.tree)
    to = torch.tensor(o, requires_grad=True)
    td = torch.tensor(d, requires_grad=True)
    out = trender.render_rays(params, w.tsc, w.trc, to, td, torch.tensor(gd),
                              draws=draws)
    loss = (torch.sum(out.rgb * torch.tensor(w_rgb))
            + torch.sum(out.depth * torch.tensor(w_d))
            + torch.sum(out.sdf * torch.tensor(w_s))
            + torch.sum(out.depth_std))
    calls = _record_table_rows(monkeypatch)
    loss.backward()
    for name in ref._fields:
        _close(getattr(out, name).detach(), getattr(ref, name), rtol=1e-4,
               atol=1e-5)
    _grad_close(to.grad, jg_o)
    _grad_close(td.grad, jg_d)
    _check_tree_grads(params, jg_tree, _table_tol(calls, w.tsc.brick_spec))
    assert params["beta"].grad is not None


def test_lod_modes_and_degenerate_splits_fall_back():
    w = BrickWorld()
    sc = w.tsc
    rc = trender.RenderConfig(n_stratified=NS, n_importance=NI)
    assert trender._lod_mode(sc, rc._replace(n_fine=0), 14) == \
        (False, False, None)
    assert trender._lod_mode(sc, rc._replace(n_fine=14), 14) == \
        (False, False, None)
    assert trender._lod_mode(sc, rc._replace(n_fine=4), 14) == \
        (True, False, (0,))
    assert trender._lod_mode(sc, rc._replace(n_fine=-1,
                                             lod_split="coarse2"), 14) == \
        (False, True, (0, 1))
    # no fine levels, or no coarse levels: the full query
    for split in ("coarse3", "coarse0"):
        assert trender._lod_mode(sc, rc._replace(n_fine=4, lod_split=split),
                                 14) == (False, False, None)
    hash_sc = World().tsc
    assert trender._lod_mode(hash_sc, rc._replace(n_fine=4), 14) == \
        (False, False, None)


# ---------------------------------------------------------------- engine

def test_brick_tracking_step_lockstep_with_jax():
    """Tracking on the brick map with room0_tpu's tracking split
    ("coarse2": the finest level in the band)."""
    w = BrickWorld(lod_split="coarse2")
    color, depth, c2w = w.frame(1)
    jtc = jtracker.TrackerConfig(**TRACK)
    ttc = ttracker.TrackerConfig(**TRACK)
    step, opt, _ = jtracker.make_tracking_step(w.jsc, w.jrc, jtc, w.jintr)
    loss_fn = inspect.getclosurevars(step.__wrapped__).nonlocals["loss_fn"]
    p7 = _pose7_near(c2w, 1)
    jpose_d = {"R": jnp.asarray(p7[:4]), "T": jnp.asarray(p7[4:])}
    key = jax.random.fold_in(jax.random.PRNGKey(11), 0)
    (jl, junc), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jpose_d, w.tree, jnp.asarray(depth), jnp.asarray(color), key)
    jnew, _, _, _ = step(w.tree, jpose_d, opt.init(jpose_d),
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
    _close(unc, junc, rtol=1e-5)
    _grad_close(pose["R"].grad, jg["R"])
    _grad_close(pose["T"].grad, jg["T"])
    _check_step(pose["R"].detach(), jnew["R"], p7[:4], jg["R"], TRACK["lr_R"])
    _check_step(pose["T"].detach(), jnew["T"], p7[4:], jg["T"], TRACK["lr_T"])
    assert all(v.grad is None for _, v in _leaves(params))


@pytest.mark.parametrize("with_holes", [False, True])
def test_brick_mapping_step_lockstep_with_jax(with_holes, monkeypatch):
    """One mapping step on the brick map with room0_tpu's mapping split
    ("cost"): loss, the gradients of the shared table, the decoders and
    the poses, and the Adam-updated values (the table at `lr_hash`). With
    holes in the depth the coarse-level probe places the band."""
    w = BrickWorld(seed=3)
    jbank, tbank, dirs = _bank(w, with_holes)
    color, depth, c2w = w.frame(5)
    jmc = jmapper.MapperConfig(**MAP)
    tmc = tmapper.MapperConfig(**MAP)
    probs = np.array([0.25, 0.25, 0.25, 0.0, 0.25])
    mask = np.array([[0.0], [1.0], [1.0], [0.0], [1.0]], np.float32)
    cur7 = _pose7_near(c2w, 4)
    poses = np.concatenate([np.asarray(jbank.pose7), cur7[None]])
    lr_scale = 5.0
    args = (jbank, jnp.asarray(depth), jnp.asarray(color), jnp.asarray(dirs),
            jnp.asarray(probs, jnp.float32), jnp.asarray(probs, jnp.float32),
            jnp.asarray(mask))
    key = jax.random.fold_in(jax.random.PRNGKey(21), 0)
    loss_fn = jmapper.make_loss_fn(w.jsc, w.jrc, jmc, w.jintr, MAX_KF, BANK)
    tree = {"scene": w.tree, "poses": jnp.asarray(poses)}
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(tree, *args, key)
    step, opt, _ = jmapper.make_mapping_step(w.jsc, w.jrc, jmc, w.jintr,
                                             MAX_KF, BANK)
    jnew, _, _ = step(tree, opt.init(tree), *args, key,
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
                             _t(probs).float(), _t(probs).float(), _t(mask),
                             probe=with_holes)
    scene, tposes = tmapper.trainable(
        tscene.params_from_jax(w.tree, device="cpu"), _t(poses))
    topt = tmapper.make_optimizer(tmc, scene, tposes, lr_scale)
    groups = topt.param_groups
    assert len(groups) == 3 and groups[1]["params"] == [scene["table"]]
    assert groups[1]["lr"] == MAP["lr_hash"] * lr_scale
    calls = _record_table_rows(monkeypatch)
    loss = mapper.step(scene, tposes, topt, batch, draws=draws)

    _close(loss, jl, rtol=1e-5)
    _check_tree_grads(scene, jg["scene"], _table_tol(calls, w.tsc.brick_spec))
    ref_leaves = dict(_leaves(jg["scene"]))
    new_leaves = dict(_leaves(jnew["scene"]))
    old_leaves = dict(_leaves(w.tree))
    for k, v in _leaves(scene):
        lr = MAP["lr_hash"] if k == "table" else MAP["lr_decoders"]
        _check_step(v.detach(), new_leaves[k], old_leaves[k], ref_leaves[k],
                    lr * lr_scale)
    _grad_close(tposes.grad, jg["poses"])
    _check_step(tposes.detach(), jnew["poses"], poses, jg["poses"],
                MAP["joint_opt_cam_lr"])


# ---------------------------------------------------------------- drive

def test_brick_synthetic_drive_tracks_under_3cm():
    """The port alone, brick encoding with the surface-LOD band (n_fine
    10 of 32 samples), on the procedural room."""
    from unislam_tpu_torch.engine.slam import UniSLAM
    from unislam_tpu_torch.tools.eval_ate import pose_evaluation

    frames = 6
    cfg, ds = _drive_config(frames, brick=True)
    slam = UniSLAM(cfg, ds, seed=0, device="cpu")
    assert slam.sc.encoding == "brick" and slam.rc.n_fine == 10
    assert slam.rc_track.n_fine == 10 and slam.rc_track.lod_split == "cost"
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
    assert set(slam.params) == {"table", "sdf_mlp", "color_mlp", "beta"}
    assert slam.iters_run["map"] >= 25 + 2 * 10
