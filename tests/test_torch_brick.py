"""Port parity for the brick encoding of `unislam_tpu_torch`: the spec and
level split, the level indices, and the plain PyTorch versions of the brick
forward (K5) and backward (K6) with the table gradient through the
scatter-accumulate (K9), against the JAX package's `brick_encoding` and the
Pallas `encode_fwd` / `encode_bwd` (interpret mode).

Tolerances (all f32; u = 2^-24):
- level indices: exact;
- features: |diff| <= 16 u * sum_v w_v |f_v| (the same rounded products,
  summed in another order);
- table-gradient rows: bitwise equal to the JAX package's bf16 rows;
- table gradient: |diff| <= n u * sum |terms| per element, n its number of
  terms (two f32 sums of the same values in possibly another order);
- point gradient: rtol 1e-5 plus 1e-6 of its largest magnitude (sums of
  exact bf16 products with cancellation, both f32);
- against the Pallas kernels, which round w*g to bf16 once from f32 and use
  the unrounded cotangent: |diff| <= 2^-6 * sum |terms|.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unislam_tpu import config as jconfig
from unislam_tpu.models import brick_encoding as jbe
from unislam_tpu.models import scene as jscene
from unislam_tpu_torch.data.synthetic import SyntheticRoom, make_config
from unislam_tpu_torch.kernels import scatter_accum as tsa
from unislam_tpu_torch.models import brick_encoding as tbe
from unislam_tpu_torch.models import scene as tscene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U = 2.0 ** -24
# 3 levels: res 8 (4^3 dense bricks, one-hot matmul in JAX), res 23 and 64
# hashed into 512 and 1024 rows
SPEC_ARGS = dict(n_levels=3, n_features=8, log2_hashmap_size=10,
                 base_resolution=8, desired_resolution=64,
                 matmul_max_rows=64, hashed_level_rows=[512, 1024])
EXAMPLE_GRID = {"encoding": "brick", "brick_levels": 3,
                "brick_features": 8, "brick_hash_size": 12}


def _specs(**kw):
    args = {**SPEC_ARGS, **kw}
    return jbe.make_spec(**args), tbe.make_spec(**args)


def _points(spec, n=400, seed=0):
    """Uniform points, points outside [0, 1], points on cell faces at
    every level, and corners of the unit cube."""
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(0.0, 1.0, (n, 3)), rng.uniform(-0.2, 1.2, (n // 4, 3))]
    for r in spec.resolutions:
        k = rng.integers(0, int(r), (n // 8, 3))
        pts.append(k / (float(r) - 1.0))
    pts.append(np.array([[0.0, 1.0, 0.5], [1.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                         [0.0, 0.0, 0.0]]))
    return np.concatenate(pts).astype(np.float32)


def _table(spec, seed=1):
    """U(-1e-4, 1e-4) like init_table, scaled by 1e3 so the comparisons
    are not all round-off."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1e-4, 1e-4, (spec.total_rows, spec.row_dim))
            * 1e3).astype(np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _spec_equal(js, ts):
    assert (js.n_levels, js.n_features, js.log2_hashmap_size) == \
        (ts.n_levels, ts.n_features, ts.log2_hashmap_size)
    for name in ("resolutions", "brick_res", "hashed", "level_rows",
                 "row_offsets", "matmul"):
        a, b = getattr(js, name), getattr(ts, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    for mode in ("cost", "hashed", "coarse1", "coarse2"):
        assert jbe.coarse_fine_split(js, mode) == \
            tbe.coarse_fine_split(ts, mode)


# ---------------------------------------------------------------- spec

def test_make_spec_and_split_match_jax(monkeypatch):
    monkeypatch.chdir(REPO)
    cfg = jconfig.load_config(
        os.path.join(REPO, "configs/Replica/room0_tpu.yaml"),
        os.path.join(REPO, "configs/UNISLAM.yaml"))
    ds = SyntheticRoom(n_frames=2)
    example = make_config(ds, {"grid": EXAMPLE_GRID})
    for c in (cfg, example):
        jsc, tsc = jscene.make_scene_config(c), tscene.make_scene_config(c)
        assert tsc.encoding == jsc.encoding == "brick"
        _spec_equal(jsc.brick_spec, tsc.brick_spec)
    # the room0_tpu ladder: 20 dense, 128 and 816 hashed into 16384 / 65536
    spec = tscene.make_scene_config(cfg).brick_spec
    assert list(spec.resolutions) == [20, 128, 816]
    assert list(spec.level_rows) == [1000, 16384, 65536]
    assert tbe.coarse_fine_split(spec, "coarse2") == ((0, 1), (2,))
    assert tbe.coarse_fine_split(spec, "cost") == ((0,), (1, 2))
    for kw in (SPEC_ARGS, dict(n_levels=4, matmul_max_rows=4096),
               dict(n_levels=4, matmul_max_rows=64, matmul_hashed=1,
                    matmul_hashed_rows=256, log2_hashmap_size=12,
                    base_resolution=4, desired_resolution=128),
               dict(n_levels=1, desired_resolution=40)):
        _spec_equal(jbe.make_spec(**kw), tbe.make_spec(**kw))


def test_init_table_range_and_generator():
    _, ts = _specs()
    a = tbe.init_table(ts, torch.Generator().manual_seed(3), device="cpu")
    b = tbe.init_table(ts, torch.Generator().manual_seed(3), device="cpu")
    assert a.shape == (ts.total_rows, 27 * 8) and a.dtype == torch.float32
    assert torch.equal(a, b) and float(a.abs().max()) <= 1e-4


# ---------------------------------------------------------------- indices

@pytest.mark.parametrize("levels", [(0, 1, 2), (2,), (0, 2)])
def test_level_indices_match_jax(levels):
    js, ts = _specs()
    pts = _points(js)
    for p in (np.clip(pts, 0.0, 1.0), pts):
        idx, local, frac = (np.asarray(x) for x in
                            jbe._level_indices(jnp.asarray(p), js, levels))
        t_idx, t_local, t_frac = tbe._level_indices(_t(p), ts, levels)
        np.testing.assert_array_equal(t_idx.numpy(), idx)
        np.testing.assert_array_equal(t_local.numpy().transpose(0, 2, 1),
                                      local)
        np.testing.assert_array_equal(t_frac.numpy().transpose(0, 2, 1),
                                      frac)


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("levels", [None, (1, 2), (0,)])
def test_encode_forward_matches_jax(levels):
    js, ts = _specs()
    table, pts = _table(js), _points(js)
    ref = np.asarray(jbe.encode(jnp.asarray(table), jnp.asarray(pts), js,
                                levels))
    out = tbe.encode(_t(table), _t(pts), ts, levels).numpy()
    lv = levels or (0, 1, 2)
    assert out.shape == (pts.shape[0], len(lv) * 8)
    ref_abs = tbe.encode_fwd_plain(_t(np.abs(table)), _t(pts), ts,
                                   lv).numpy()
    err = np.abs(out - ref)
    assert (err <= 16 * U * ref_abs).all(), err.max()


# ---------------------------------------------------------------- backward

def _dense_rows(row_idx, rows, spec, levels, N):
    """K6's (L*N*8) vertex rows -> the JAX layout: per level, the brick
    row index (N,) and the (N, 27F) row with zeros at untouched vertices."""
    L, F = len(levels), spec.n_features
    vidx = row_idx.numpy().reshape(L, N, 8)
    vals = rows.numpy().reshape(L, N, 8, F)
    brick, slot = vidx // 27, vidx % 27
    dense = np.zeros((L, N, 27, F), np.float32)
    for k in range(8):
        dense[np.arange(L)[:, None], np.arange(N)[None], slot[..., k]] = \
            vals[:, :, k]
    offs = spec.row_offsets[list(levels)][:, None]
    assert (brick == brick[..., :1]).all()
    return brick[..., 0] - offs, dense.reshape(L, N, 27 * F)


@pytest.mark.parametrize("levels", [(0, 1, 2), (1, 2)])
def test_encode_backward_matches_jax(levels):
    js, ts = _specs()
    table, pts = _table(js), _points(js)
    N = pts.shape[0]
    g = np.random.default_rng(2).normal(
        size=(N, len(levels) * 8)).astype(np.float32)
    # row cotangents: bitwise the JAX package's bf16 segments
    _, res = jbe._encode_fwd(jnp.asarray(table), jnp.asarray(pts), js,
                             levels)
    segs, jg_p_group = jbe._bwd_group(js, levels, res, jnp.asarray(g))
    g_pts, row_idx, rows = tbe.encode_bwd_plain(_t(table), _t(pts), _t(g),
                                                ts, levels)
    assert row_idx.dtype == torch.int32 and rows.shape == (len(levels) * N * 8,
                                                           8)
    brick, dense = _dense_rows(row_idx, rows, ts, levels, N)
    for k, (l, idx, g_rows) in enumerate(segs):
        assert l == levels[k]
        np.testing.assert_array_equal(brick[k], np.asarray(idx))
        ref = np.asarray(g_rows.astype(jnp.float32))
        assert (dense[k] == ref).all()
    np.testing.assert_allclose(g_pts.numpy(), np.asarray(jg_p_group),
                               rtol=1e-5,
                               atol=1e-6 * np.abs(jg_p_group).max())

    # through jax.vjp and the autograd Function: table and point gradients
    _, vjp = jax.vjp(lambda t, p: jbe.encode(t, p, js, levels),
                     jnp.asarray(table), jnp.asarray(pts))
    jg_table, jg_pts = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    t_table = _t(table).requires_grad_(True)
    t_pts = _t(pts).requires_grad_(True)
    tbe.encode(t_table, t_pts, ts, levels).backward(_t(g))
    T = ts.total_rows * 27
    abs_sum = tsa.scatter_accumulate_plain(row_idx, rows.abs(), T)
    count = tsa.scatter_accumulate_plain(row_idx, torch.ones_like(rows), T)
    tol = (count * U * abs_sum).view(ts.total_rows, -1).numpy()
    err = np.abs(t_table.grad.numpy() - jg_table)
    assert (err <= tol).all(), err.max()
    assert (count > 1).any()
    gp = t_pts.grad.numpy()
    np.testing.assert_allclose(gp, jg_pts, rtol=1e-5,
                               atol=1e-6 * np.abs(jg_pts).max())
    outside = (pts < 0.0) | (pts > 1.0)
    assert outside.any() and (gp[outside] == 0.0).all()


def test_encode_multi_matches_jax():
    """Three point sets over overlapping level sets, one fused backward."""
    js, ts = _specs()
    table = _table(js)
    groups = [(0, 1), (1, 2), (2,)]
    pts = [_points(js, n, seed) for n, seed in ((300, 4), (160, 5),
                                                (120, 6))]
    rng = np.random.default_rng(7)
    gs = [rng.normal(size=(p.shape[0], len(lv) * 8)).astype(np.float32)
          for p, lv in zip(pts, groups)]
    refs, vjp = jax.vjp(
        lambda t, *p: jbe.encode_multi(t, p, js, groups),
        jnp.asarray(table), *(jnp.asarray(p) for p in pts))
    jg = [np.asarray(x) for x in vjp(tuple(jnp.asarray(g) for g in gs))]

    t_table = _t(table).requires_grad_(True)
    t_pts = [_t(p).requires_grad_(True) for p in pts]
    outs = tbe.encode_multi(t_table, t_pts, ts, groups)
    torch.autograd.backward(outs, [_t(g) for g in gs])
    for out, ref, p, lv in zip(outs, refs, pts, groups):
        ref_abs = tbe.encode_fwd_plain(_t(np.abs(table)), _t(p), ts, lv)
        assert (np.abs(out.detach().numpy() - np.asarray(ref))
                <= 16 * U * ref_abs.numpy()).all()
    parts = [tbe.encode_bwd_plain(_t(table), _t(p), _t(g), ts, lv,
                                  need_points=False)
             for p, g, lv in zip(pts, gs, groups)]
    row_idx = torch.cat([r for _, r, _ in parts])
    rows = torch.cat([v for _, _, v in parts])
    T = ts.total_rows * 27
    abs_sum = tsa.scatter_accumulate_plain(row_idx, rows.abs(), T)
    count = tsa.scatter_accumulate_plain(row_idx, torch.ones_like(rows), T)
    tol = (count * U * abs_sum).view(ts.total_rows, -1).numpy()
    assert (np.abs(t_table.grad.numpy() - jg[0]) <= tol).all()
    for tp, ref in zip(t_pts, jg[1:]):
        np.testing.assert_allclose(tp.grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())
    with pytest.raises(NotImplementedError):
        tbe.encode_multi(t_table, t_pts[:1], ts, groups[:1],
                         dedup=[(10, 3, 2)])


def test_vertex_rows_equal_full_rows_bitwise():
    """K6 emits 8 F-wide vertex rows per (point, level); the JAX package
    scatters 27F-wide rows whose 19 other vertices hold zeros. Reduced by
    the scatter-accumulate, both give the same table gradient bit for
    bit."""
    js, ts = _specs()
    levels = (0, 1, 2)
    table, pts = _table(js), _points(js, 500, 8)
    N = pts.shape[0]
    g = np.random.default_rng(9).normal(size=(N, 24)).astype(np.float32)
    _, row_idx, rows = tbe.encode_bwd_plain(_t(table), _t(pts), _t(g), ts,
                                            levels, need_points=False)
    vertex = tsa.scatter_accumulate_plain(row_idx, rows,
                                          ts.total_rows * 27)
    brick, dense = _dense_rows(row_idx, rows, ts, levels, N)
    offs = ts.row_offsets[list(levels)][:, None]
    full = tsa.scatter_accumulate_plain(
        _t((brick + offs).reshape(-1).astype(np.int32)),
        _t(dense.reshape(-1, 216)), ts.total_rows)
    assert torch.equal(vertex.view(ts.total_rows, 216), full)


def test_frozen_table_forms_no_table_gradient(monkeypatch):
    """Tracking freezes the scene: the backward then emits no table rows
    and never reaches the scatter-accumulate."""
    _, ts = _specs()
    calls = []

    def no_scatter(*a, **k):
        raise AssertionError("scatter_accumulate called for a frozen table")

    real_bwd = tbe.encode_bwd

    def spy_bwd(table, points, g_out, spec, levels, need_points, need_rows):
        calls.append((levels, need_points, need_rows))
        return real_bwd(table, points, g_out, spec, levels, need_points,
                        need_rows)

    monkeypatch.setattr(tbe, "scatter_accumulate", no_scatter)
    monkeypatch.setattr(tbe, "encode_bwd", spy_bwd)
    table = _t(_table(ts))
    pts = _t(_points(ts, 40)).requires_grad_(True)
    sum(o.sum() for o in tbe.encode_multi(table, [pts, pts], ts,
                                          [(0,), (1, 2)])).backward()
    assert pts.grad is not None and table.grad is None
    assert calls == [((0,), True, False), ((1, 2), True, False)]


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises (meta
    tensors stand in for a device without the kernel)."""
    _, ts = _specs()
    table = torch.empty(ts.total_rows, ts.row_dim, device="meta")
    pts = torch.empty(10, 3, device="meta")
    with pytest.raises(ValueError):
        tbe.encode_fwd(table, pts, ts, (0, 1))
    with pytest.raises(ValueError):
        tbe.encode_bwd(table, pts, torch.empty(10, 16, device="meta"), ts,
                       (0, 1))
    with pytest.raises(ValueError):   # mixed CPU / other device
        tbe.encode_fwd(torch.zeros(ts.total_rows, ts.row_dim), pts, ts, (0,))
    _, ts2 = _specs(n_features=2)
    with pytest.raises(ValueError, match="F = 8"):
        tbe._kernel_args(ts2, (0,), torch.empty(ts2.total_rows, ts2.row_dim,
                                                device="meta"), pts)


# ---------------------------------------------------------------- Pallas

def _pallas_module():
    path = os.path.join(REPO, "examples", "pallas_fused_dense.py")
    spec = importlib.util.spec_from_file_location("pallas_fused_dense", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plain_kernels_match_pallas_kernels():
    """K5 and K6's plain versions against the Pallas `encode_fwd` /
    `encode_bwd` themselves (interpret mode), the level metadata holding
    the levels' global row offsets into the whole table."""
    from jax.experimental.pallas import tpu as pltpu
    fd = _pallas_module()
    js, ts = _specs()
    levels = (0, 1, 2)
    table = _table(js)
    pts = np.clip(_points(js, 240, 10), 0.0, 1.0)
    N, L = pts.shape[0], len(levels)
    g = np.random.default_rng(11).normal(size=(N, L * 8)).astype(np.float32)
    idx, local, frac = jbe._level_indices(jnp.asarray(pts), js, levels)
    metas = [fd.LevelMeta(rows=int(js.level_rows[l]),
                          offset=int(js.row_offsets[l])) for l in levels]
    local, frac = (jnp.moveaxis(a, 0, 1).reshape(N, 3 * L)
                   for a in (local, frac))
    with pltpu.force_tpu_interpret_mode():
        feat, rows_res = fd.encode_fwd(jnp.asarray(table, jnp.bfloat16),
                                       idx.T, local, frac, metas, 8)
        g_tab, g_frac = fd.encode_bwd(idx.T, local, frac, rows_res,
                                      jnp.asarray(g), metas, 8,
                                      js.total_rows)
    feat, g_tab, g_frac = (np.asarray(x) for x in (feat, g_tab, g_frac))

    out = tbe.encode_fwd_plain(_t(table), _t(pts), ts, levels).numpy()
    ref_abs = tbe.encode_fwd_plain(_t(np.abs(table)), _t(pts), ts,
                                   levels).numpy()
    assert (np.abs(out - feat) <= 32 * U * ref_abs).all()

    g_pts, row_idx, rows = tbe.encode_bwd_plain(_t(table), _t(pts), _t(g),
                                                ts, levels)
    T = ts.total_rows * 27
    ours = tsa.scatter_accumulate_plain(row_idx, rows, T).view(
        ts.total_rows, -1).numpy()
    abs_sum = tsa.scatter_accumulate_plain(row_idx, rows.abs(), T).view(
        ts.total_rows, -1).numpy()
    assert (np.abs(ours - g_tab) <= 2.0 ** -6 * abs_sum + 1e-30).all()
    assert np.abs(g_tab).max() > 0.1

    res_m1 = (js.resolutions[list(levels)].astype(np.float32) - 1.0)
    g_p_pallas = (g_frac.reshape(N, L, 3) * res_m1[None, :, None]).sum(1)
    # sum |terms| of the point gradient: |row . g| times the other two
    # axes' weights, over the footprint's 8 vertices and the levels
    vidx, wl = tbe._footprint(ts, _t(pts), levels)
    g_w = (tbe._gather_bf16(_t(np.abs(table)), vidx, 8)
           * _t(np.abs(g)).view(N, L, 8).permute(1, 0, 2)[:, None]).sum(-1)
    w = wl.numpy()
    g_w = g_w.numpy().reshape(L, 2, 2, 2, N)
    terms = np.stack([
        (g_w * w[:, 1, None, :, None] * w[:, 2, None, None, :]).sum((1, 2, 3)),
        (g_w * w[:, 0, :, None, None] * w[:, 2, None, None, :]).sum((1, 2, 3)),
        (g_w * w[:, 0, :, None, None] * w[:, 1, None, :, None]).sum((1, 2, 3)),
    ], axis=-1)                                                  # (L, N, 3)
    mag = (terms * res_m1[:, None, None]).sum(0)
    assert (np.abs(g_pts.numpy() - g_p_pallas) <= 2.0 ** -6 * mag).all()
