"""Port parity for the config loader and the core math of
`unislam_tpu_torch` (pose, rays, sampling, losses) against the JAX package,
on the same numpy inputs and the same random draws.

Tolerances: f32 elementwise math, rtol 1e-5 / atol 1e-6 unless a test says
otherwise; integer and boolean results exactly.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unislam_tpu import config as jconfig
from unislam_tpu.core import losses as jlosses
from unislam_tpu.core import pose as jpose
from unislam_tpu.core import rays as jrays
from unislam_tpu.core import sampling as jsampling
from unislam_tpu_torch import config as tconfig
from unislam_tpu_torch import resolve_device
from unislam_tpu_torch.core import losses as tlosses
from unislam_tpu_torch.core import pose as tpose
from unislam_tpu_torch.core import rays as trays
from unislam_tpu_torch.core import rng as trng
from unislam_tpu_torch.core import sampling as tsampling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(kw or TOL))


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True)))
def test_config_loads_like_jax(path, monkeypatch):
    monkeypatch.chdir(REPO)
    default = os.path.join(REPO, "configs", "UNISLAM.yaml")
    assert tconfig.load_config(path, default) == \
        jconfig.load_config(path, default)


def test_update_recursive_matches_jax():
    a = {"x": {"y": 1, "z": [1]}, "w": 2}
    b = {"x": {"y": 3, "n": {"m": 1}}, "w": {"v": 1}}
    ja, ta = {**a, "x": dict(a["x"])}, {**a, "x": dict(a["x"])}
    jconfig.update_recursive(ja, b)
    tconfig.update_recursive(ta, b)
    assert ja == ta


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_rng_streams_are_keyed_by_iteration():
    """Iteration i's draws depend only on (seed, i)."""
    a = torch.rand(4, generator=trng.generator(trng.fold_in(7, 3)))
    b = torch.rand(4, generator=trng.generator(trng.fold_in(7, 3)))
    c = torch.rand(4, generator=trng.generator(trng.fold_in(7, 4)))
    assert torch.equal(a, b) and not torch.equal(a, c)
    s1, s2 = trng.SeedStream(0), trng.SeedStream(0)
    assert [s1.next() for _ in range(3)] == [s2.next() for _ in range(3)]


# ---------------------------------------------------------------- pose

def _quats(n=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q[:8, 0] = 1e-4          # rotations near 180 degrees (w ~ 0)
    q[8:12] = [[0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0]]
    return q.astype(np.float32)


def test_quaternion_matrix_roundtrip_matches_jax():
    q = _quats()
    _close(tpose.quaternion_to_matrix(_t(q)),
           jpose.quaternion_to_matrix(jnp.asarray(q)))
    m = np.asarray(jpose.quaternion_to_matrix(jnp.asarray(q)))
    _close(tpose.matrix_to_quaternion(_t(m)),
           jpose.matrix_to_quaternion(jnp.asarray(m)), rtol=1e-4, atol=1e-5)


def test_cam_pose_conversions_match_jax():
    rng = np.random.default_rng(1)
    p7 = np.concatenate([_quats(16, 2), rng.normal(size=(16, 3))],
                        axis=1).astype(np.float32)
    c2w_j = jpose.cam_pose_to_matrix(jnp.asarray(p7))
    c2w_t = tpose.cam_pose_to_matrix(_t(p7))
    _close(c2w_t, c2w_j)
    _close(tpose.matrix_to_cam_pose(c2w_t),
           jpose.matrix_to_cam_pose(c2w_j), rtol=1e-4, atol=1e-5)


def test_quaternion_to_matrix_gradient_matches_jax():
    q = _quats(16, 3)
    g = np.random.default_rng(4).normal(size=(16, 3, 3)).astype(np.float32)
    _, vjp = jax.vjp(jpose.quaternion_to_matrix, jnp.asarray(q))
    ref = vjp(jnp.asarray(g))[0]
    qt = _t(q).requires_grad_(True)
    tpose.quaternion_to_matrix(qt).backward(_t(g))
    _close(qt.grad, ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- rays

INTR_ARGS = dict(H=24, W=32, fx=30.0, fy=28.0, cx=15.5, cy=11.5)


def _c2w(seed=5, n=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if n else (1,)
    p7 = np.concatenate([rng.normal(size=shape + (4,)),
                         rng.normal(size=shape + (3,))], axis=-1)
    c2w = np.asarray(jpose.cam_pose_to_matrix(jnp.asarray(p7, jnp.float32)))
    return c2w if n else c2w[0]


def test_ray_generation_matches_jax():
    ji, ti = jrays.Intrinsics(**INTR_ARGS), trays.Intrinsics(**INTR_ARGS)
    _close(trays.camera_ray_dirs(ti, device="cpu"), jrays.camera_ray_dirs(ji))
    c2w = _c2w()
    for a, b in zip(trays.get_rays(ti, _t(c2w)),
                    jrays.get_rays(ji, jnp.asarray(c2w))):
        _close(a, b)
    rng = np.random.default_rng(6)
    i = rng.uniform(0, 32, 50).astype(np.float32)
    j = rng.uniform(0, 24, 50).astype(np.float32)
    for pose in (c2w, _c2w(7, 50)):        # one pose, or one per ray
        for a, b in zip(trays.rays_from_uv(_t(i), _t(j), _t(pose), ti),
                        jrays.rays_from_uv(jnp.asarray(i), jnp.asarray(j),
                                           jnp.asarray(pose), ji)):
            _close(a, b)


def test_sample_pixels_with_jax_draws():
    rng = np.random.default_rng(8)
    depth = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
    color = rng.uniform(size=(24, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jrays.sample_pixels(key, 40, 2, 20, 3, 30, jnp.asarray(depth),
                              jnp.asarray(color))
    kj, ki = jax.random.split(key)
    ij = (np.asarray(jax.random.randint(ki, (40,), 3, 30)),
          np.asarray(jax.random.randint(kj, (40,), 2, 20)))
    out = trays.sample_pixels(40, 2, 20, 3, 30, _t(depth), _t(color),
                              ij=tuple(_t(x) for x in ij))
    for a, b in zip(out, ref):
        _close(a, b, rtol=0, atol=0)
    i, j, _, _ = trays.sample_pixels(500, 2, 20, 3, 30, _t(depth),
                                     _t(color), trng.generator(1))
    assert (j >= 2).all() and (j < 20).all() and (i >= 3).all() \
        and (i < 30).all()


def test_ray_aabb_far_matches_jax():
    rng = np.random.default_rng(9)
    o = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    bound = np.array([[-1, 2], [-1.5, 1], [-2, 2.5]], np.float32)
    _close(trays.ray_aabb_far(_t(o), _t(d), _t(bound)),
           jrays.ray_aabb_far(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(bound)))


# ---------------------------------------------------------------- sampling

def test_perturb_and_depth_guided_z_match_jax():
    rng = np.random.default_rng(10)
    gd = rng.uniform(0.3, 4.0, 30).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jsampling.z_vals_with_depth(key, jnp.asarray(gd), 0.06, 12, 5,
                                      True)
    t_rand = jax.random.uniform(key, (30, 17))
    out = tsampling.z_vals_with_depth(_t(gd), 0.06, 12, 5, True,
                                      t_rand=_t(t_rand))
    _close(out, ref)
    _close(tsampling.z_vals_with_depth(_t(gd), 0.06, 12, 5, False),
           jsampling.z_vals_with_depth(key, jnp.asarray(gd), 0.06, 12, 5,
                                       False))
    far = rng.uniform(1.0, 5.0, 30).astype(np.float32)
    _close(tsampling.z_vals_uniform(_t(far), 12, True,
                                    t_rand=_t(jax.random.uniform(key,
                                                                 (30, 12)))),
           jsampling.z_vals_uniform(key, jnp.asarray(far), 12, True))


@pytest.mark.parametrize("normalize,det", [(False, False), (True, False),
                                           (False, True)])
def test_sample_pdf_matches_jax(normalize, det):
    """Including the unnormalised-CDF quirk (normalize=False) and rays
    whose weights are all zero."""
    rng = np.random.default_rng(11)
    bins = np.sort(rng.uniform(0, 5, (40, 15)), axis=1).astype(np.float32)
    w = rng.uniform(size=(40, 15)).astype(np.float32) * 0.2
    w[:4] = 0.0
    if normalize:
        w[:4] = 1.0
    key = jax.random.PRNGKey(5)
    ref = jsampling.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 9,
                               det=det, normalize=normalize)
    u = jax.random.uniform(key, (40, 9))
    out = tsampling.sample_pdf(_t(bins), _t(w), 9, det=det,
                               normalize=normalize, u=_t(u))
    _close(out, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("count", [0, 1, 6, 7])
def test_masked_median_matches_jax(count):
    rng = np.random.default_rng(count)
    x = rng.uniform(size=20).astype(np.float32)
    mask = np.zeros(20, bool)
    mask[rng.choice(20, count, replace=False)] = True
    ref = jlosses.masked_median(jnp.asarray(x), jnp.asarray(mask))
    out = tlosses.masked_median(_t(x), _t(mask))
    _close(out, ref, rtol=0, atol=0)
    _close(tlosses.masked_mean(_t(x), _t(mask)),
           jlosses.masked_mean(jnp.asarray(x), jnp.asarray(mask)))


def test_losses_and_gradients_match_jax():
    rng = np.random.default_rng(12)
    R, S, trunc = 50, 20, 0.06
    sdf = rng.normal(size=(R, S)).astype(np.float32) * 0.5
    gd = rng.uniform(0.5, 3.0, R).astype(np.float32)
    z = np.sort(rng.uniform(0.0, 3.5, (R, S)), axis=1).astype(np.float32)
    z[:, 5:9] = gd[:, None] + np.linspace(-0.02, 0.05, 4)[None]
    mask = (rng.uniform(size=R) > 0.3).astype(np.float32)
    rgb = rng.uniform(size=(R, 3)).astype(np.float32)
    gt_rgb = rng.uniform(size=(R, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, R).astype(np.float32)
    jw = jlosses.SdfLossWeights(5.0, 200.0, 10.0)
    tw = tlosses.SdfLossWeights(5.0, 200.0, 10.0)

    def jloss(sdf, rgb, depth):
        return (jlosses.sdf_losses(sdf, jnp.asarray(z), jnp.asarray(gd),
                                   jnp.asarray(mask), trunc, jw)
                + jlosses.color_loss(jnp.asarray(gt_rgb), rgb,
                                     jnp.asarray(mask))
                + jlosses.depth_loss(jnp.asarray(gd), depth,
                                     jnp.asarray(mask)))

    ref, grads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(sdf), jnp.asarray(rgb), jnp.asarray(depth))
    ts, tr, td = (_t(x).requires_grad_(True) for x in (sdf, rgb, depth))
    out = (tlosses.sdf_losses(ts, _t(z), _t(gd), _t(mask), trunc, tw)
           + tlosses.color_loss(_t(gt_rgb), tr, _t(mask))
           + tlosses.depth_loss(_t(gd), td, _t(mask)))
    out.backward()
    _close(out.detach(), ref)
    for a, b in zip((ts.grad, tr.grad, td.grad), grads):
        _close(a, b)
