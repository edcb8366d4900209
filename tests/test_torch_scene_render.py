"""Port parity for the decoders, the hash-mode scene and the volume renderer
of `unislam_tpu_torch` against the JAX package: the same parameters
(carried across with `params_from_jax`), the same inputs and the same
random draws (the JAX run's own draws, injected).

Tolerances: values rtol 1e-5 / atol 1e-6; gradients rtol 1e-4 plus 1e-5
of the largest magnitude of the leaf (f32 sums over many samples, taken in
another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unislam_tpu import config as jconfig
from unislam_tpu.models import decoders as jdec
from unislam_tpu.models import hash_encoding as jhe
from unislam_tpu.models import scene as jscene
from unislam_tpu.render import renderer as jrender
from unislam_tpu_torch.models import decoders as tdec
from unislam_tpu_torch.models import hash_encoding as the
from unislam_tpu_torch.models import scene as tscene
from unislam_tpu_torch.render import renderer as trender

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(n_levels=4, n_features=2, log2_hashmap_size=12,
            base_resolution=4, desired_resolution=64)
BOUND = np.array([[-1.5, 1.5], [-1.2, 1.2], [-1.0, 1.0]], np.float32)


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _grad_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    _close(a, b, rtol=1e-4, atol=1e-5 * max(np.abs(b).max(), 1e-12))


def _configs():
    color = {**SPEC, "log2_hashmap_size": 11}
    jsc = jscene.SceneConfig(jhe.make_spec(**SPEC), jhe.make_spec(**color),
                             BOUND, truncation=0.1)
    tsc = tscene.SceneConfig(the.make_spec(**SPEC), the.make_spec(**color),
                             BOUND, truncation=0.1)
    return jsc, tsc


def _params(jsc, seed=0):
    """JAX-initialised parameters with tables widened from the +-1e-4 init
    so the decoders see real features."""
    tree = jax.tree_util.tree_map(
        np.asarray, jscene.init_params(jax.random.PRNGKey(seed), jsc))
    rng = np.random.default_rng(seed)
    for k in ("sdf_table", "color_table"):
        tree[k] = rng.uniform(-0.5, 0.5, tree[k].shape).astype(np.float32)
    return tree


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


# ---------------------------------------------------------------- decoders

def test_mlp_matches_jax():
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init_mlp(jax.random.PRNGKey(1), 8, 16, 3, 2))
    x = np.random.default_rng(1).normal(size=(64, 8)).astype(np.float32)
    g = np.random.default_rng(2).normal(size=(64, 3)).astype(np.float32)
    for act in ("sigmoid", "tanh", "none"):
        ref, vjp = jax.vjp(lambda p, x: jdec.mlp_apply(p, x, act), params,
                           jnp.asarray(x))
        jg_p, jg_x = vjp(jnp.asarray(g))
        tp = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
        tx = torch.tensor(x, requires_grad=True)
        out = tdec.mlp_apply(tp, tx, act)
        out.backward(torch.tensor(g))
        _close(out.detach(), ref)
        _grad_close(tx.grad, jg_x)
        for k in params:
            _grad_close(tp[k].grad, jg_p[k])


def test_mlp_init_layout_and_fused_variant_raises():
    jp = jdec.init_mlp(jax.random.PRNGKey(0), 32, 16, 1, 2)
    tp = tdec.init_mlp(32, 16, 1, 2, torch.Generator().manual_seed(0),
                       device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k, v in tp.items():
        bound = 1.0 / np.sqrt(v.shape[0] if k.startswith("w") else
                              tp["w" + k[1:]].shape[0])
        assert float(v.abs().max()) <= bound
    with pytest.raises(NotImplementedError):
        tdec.init_fused_mlp(32, 16, 1, 2)
    with pytest.raises(NotImplementedError):
        tdec.mlp_apply({"w0": torch.zeros(32, 16)}, torch.zeros(2, 32),
                       "tanh")


# ---------------------------------------------------------------- scene

def test_make_scene_config_matches_jax(monkeypatch):
    monkeypatch.chdir(REPO)
    cfg = jconfig.load_config(os.path.join(REPO, "configs/Replica/room0.yaml"),
                              os.path.join(REPO, "configs/UNISLAM.yaml"))
    jsc, tsc = jscene.make_scene_config(cfg), tscene.make_scene_config(cfg)
    np.testing.assert_array_equal(jsc.bound, tsc.bound)
    for name in ("truncation", "hidden_size", "n_blocks",
                 "learnable_beta", "beta_init", "encoding"):
        assert getattr(jsc, name) == getattr(tsc, name)
    for js, ts in ((jsc.sdf_spec, tsc.sdf_spec),
                   (jsc.color_spec, tsc.color_spec)):
        np.testing.assert_array_equal(js.offsets, ts.offsets)
        np.testing.assert_array_equal(js.scales, ts.scales)
    # the brick encoding is ported (tests/test_torch_brick.py holds its
    # ladder to the JAX package's); the fused decoders and unknown
    # encodings are refused
    brick = {**cfg, "grid": {**cfg["grid"], "encoding": "brick"}}
    assert tscene.make_scene_config(brick).brick_spec.n_levels == \
        jscene.make_scene_config(brick).brick_spec.n_levels
    with pytest.raises(NotImplementedError):
        tscene.make_scene_config({**cfg, "grid": {**cfg["grid"],
                                                  "tcnn_network": True}})
    with pytest.raises(ValueError):
        tscene.make_scene_config({**cfg, "grid": {**cfg["grid"],
                                                  "encoding": "planes"}})


def test_params_carry_across_both_ways():
    jsc, tsc = _configs()
    tree = _params(jsc)
    params = tscene.params_from_jax(tree, device="cpu")
    back = tscene.params_to_numpy(params)
    for (k1, a), (k2, b) in zip(_leaves(tree), _leaves(back)):
        assert k1 == k2
        np.testing.assert_array_equal(a, b)
    fresh = tscene.init_params(tsc, torch.Generator().manual_seed(0),
                               device="cpu")
    assert sorted((k, tuple(v.shape)) for k, v in _leaves(fresh)) == \
        sorted((k, tuple(np.shape(v))) for k, v in _leaves(tree))
    assert float(fresh["sdf_table"].abs().max()) <= 1e-4


def test_scene_query_and_gradients_match_jax():
    jsc, tsc = _configs()
    tree = _params(jsc)
    rng = np.random.default_rng(3)
    p = rng.uniform(-0.05, 1.05, (300, 3)).astype(np.float32)
    g = rng.normal(size=(300, 4)).astype(np.float32)
    ref, vjp = jax.vjp(lambda prm, x: jscene.query(prm, jsc, x), tree,
                       jnp.asarray(p))
    jg_tree, jg_p = vjp(jnp.asarray(g))

    params = tscene.params_from_jax(tree, device="cpu")
    for _, v in _leaves(params):
        v.requires_grad_(True)
    tp = torch.tensor(p, requires_grad=True)
    out = tscene.query(params, tsc, tp)
    out.backward(torch.tensor(g))
    _close(out.detach(), ref)
    _grad_close(tp.grad, jg_p)
    for (k, a), (_, b) in zip(_leaves(params), _leaves(jg_tree)):
        if k == "beta":
            assert a.grad is None     # beta is not used by the query
            continue
        _grad_close(a.grad, b)
    assert float(tscene.beta_value(params, tsc).detach()) == 10.0


# ---------------------------------------------------------------- renderer

def test_exclusive_cumprod_weights_match_jax_doubling():
    rng = np.random.default_rng(4)
    alpha = rng.uniform(size=(32, 40)).astype(np.float32)
    _close(trender.exclusive_cumprod_weights(torch.tensor(alpha)),
           jrender._exclusive_cumprod_weights(jnp.asarray(alpha)))
    x = torch.tensor(rng.uniform(0.1, 1.0, (4, 9)), dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(trender._NonzeroCumprod.apply, (x,))
    sdf = rng.normal(size=(32, 40)).astype(np.float32)
    _close(trender.sdf2alpha(torch.tensor(sdf), torch.tensor(10.0)),
           jrender.sdf2alpha(jnp.asarray(sdf), jnp.float32(10.0)))


def _rays(R, seed, no_depth):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    gd = rng.uniform(0.3, 0.9, R).astype(np.float32)
    gd[:no_depth] = 0.0
    return o, d, gd


@pytest.mark.parametrize("no_depth", [0, 9])
def test_render_rays_matches_jax_with_injected_draws(no_depth):
    """Depth-guided rays, and (no_depth > 0) rays without sensor depth,
    which go through the gradient-free importance probe."""
    jsc, tsc = _configs()
    tree = _params(jsc, seed=5)
    R, ns, ni = 48, 10, 4
    o, d, gd = _rays(R, 6, no_depth)
    key = jax.random.PRNGKey(7)
    jrc = jrender.RenderConfig(n_stratified=ns, n_importance=ni)
    trc = trender.RenderConfig(n_stratified=ns, n_importance=ni)
    k_surf, k_uni, k_pdf = jax.random.split(key, 3)
    draws = {"t_depth": jax.random.uniform(k_surf, (R, ns + ni)),
             "t_uni": jax.random.uniform(k_uni, (R, ns)),
             "u_pdf": jax.random.uniform(k_pdf, (R, ni))}
    draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    cot = np.random.default_rng(8)

    def jloss(prm, o, d):
        out = jrender.render_rays(prm, jsc, jrc, o, d, jnp.asarray(gd), key)
        return out, (jnp.sum(out.rgb * w_rgb) + jnp.sum(out.depth * w_d)
                     + jnp.sum(out.sdf * w_s) + jnp.sum(out.depth_std)
                     + jnp.sum(out.pixel_unc))

    w_rgb = cot.normal(size=(R, 3)).astype(np.float32)
    w_d = cot.normal(size=R).astype(np.float32)
    w_s = cot.normal(size=(R, ns + ni)).astype(np.float32)
    ref, _ = jloss(tree, jnp.asarray(o), jnp.asarray(d))
    grads = jax.grad(lambda *a: jloss(*a)[1], argnums=(0, 1, 2))(
        tree, jnp.asarray(o), jnp.asarray(d))

    params = tscene.params_from_jax(tree, device="cpu")
    for _, v in _leaves(params):
        v.requires_grad_(True)
    to = torch.tensor(o, requires_grad=True)
    td = torch.tensor(d, requires_grad=True)
    out = trender.render_rays(params, tsc, trc, to, td, torch.tensor(gd),
                              draws=draws)
    loss = (torch.sum(out.rgb * torch.tensor(w_rgb))
            + torch.sum(out.depth * torch.tensor(w_d))
            + torch.sum(out.sdf * torch.tensor(w_s))
            + torch.sum(out.depth_std) + torch.sum(out.pixel_unc))
    loss.backward()

    for name in ref._fields:
        _close(getattr(out, name).detach(), getattr(ref, name), rtol=1e-4,
               atol=1e-5)
    jg_tree, jg_o, jg_d = grads
    _grad_close(to.grad, jg_o)
    _grad_close(td.grad, jg_d)
    for (k, a), (_, b) in zip(_leaves(params), _leaves(jg_tree)):
        _grad_close(a.grad, b)


def test_render_probe_skipped_when_every_ray_has_depth(monkeypatch):
    """The probe runs only when some ray lacks depth; asking (probe=None)
    and being told (probe=False) give the same render."""
    jsc, tsc = _configs()
    params = tscene.params_from_jax(_params(jsc), device="cpu")
    o, d, gd = _rays(16, 9, 0)
    trc = trender.RenderConfig(n_stratified=6, n_importance=3)
    calls = []
    real = trender._probe_z_vals
    monkeypatch.setattr(trender, "_probe_z_vals",
                        lambda *a: calls.append(1) or real(*a))
    outs = [trender.render_rays(params, tsc, trc, torch.tensor(o),
                                torch.tensor(d), torch.tensor(gd),
                                torch.Generator().manual_seed(0),
                                probe=probe) for probe in (None, False)]
    assert not calls
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    gd[3] = 0.0
    trender.render_rays(params, tsc, trc, torch.tensor(o), torch.tensor(d),
                        torch.tensor(gd), torch.Generator().manual_seed(0))
    assert calls == [1]
