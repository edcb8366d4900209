"""Port parity for the band row dedup (`rendering.dedup_band`): the plain
version of kernel K8 (`kernels/band_dedup.py: dedup_rows_plain`) against
the JAX package's `brick_encoding._dedup_rows`, `encode_multi(dedup=...)`,
and `query_lod` / `query_lod_field` with `dedup`.

The port keeps the table-gradient rows as 8 F-wide vertex rows a sample
(K6's layout); the JAX package as one 27F-wide brick row. The cases put the
same values into both layouts: each sample's 8 vertex rows are the nonzero
slots of its brick row.

Tolerances:
- the dedup's rows: bitwise equal to JAX's (the same f32 prefix over the
  ray's samples, the same boundary differences, the same bf16 rounding),
  compared with `==` (JAX's untouched slots can be -0.0, the port's are
  +0.0) and NaN matching NaN; the destinations equal;
- table gradients: |diff| <= n u * sum |terms| per element, n its number
  of terms (JAX sums the same terms in f32 in another order; the port's
  scatter is exact);
- point gradients and query values and gradients: as the no-dedup tests
  (`tests/test_torch_brick.py`, `tests/test_torch_lod.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lod import (LADDER, N_FINE, BrickWorld, _check_tree_grads,
                            _close, _grad_close, _record_table_rows,
                            _selection, _table_tol, _trainable)
from unislam_tpu.models import brick_encoding as jbe
from unislam_tpu.models import scene as jscene
from unislam_tpu_torch.kernels import band_dedup as tbd
from unislam_tpu_torch.kernels import build
from unislam_tpu_torch.kernels import scatter_accum as tsa
from unislam_tpu_torch.models import brick_encoding as tbe
from unislam_tpu_torch.models import scene as tscene

U = 2.0 ** -24
F = 8
# the footprint's 8 corners (x slowest) as offsets from the local cell
CORNERS = np.array([[a, b, c] for a in (0, 1) for b in (0, 1)
                    for c in (0, 1)])

_jdedup = jax.jit(jbe._dedup_rows, static_argnums=(2, 3, 4))


def _bf16(x):
    return torch.as_tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _case(bricks, seed, values=None):
    """Rows for brick rows `bricks` (L, R, K): a random in-brick cell per
    sample and bf16 values (or `values` (L, R, K, 8, F)). Returns the
    port's (row_idx, rows) in K6's order and the same values in JAX's
    (L, R*K, 27F) layout, its untouched slots signed zeros."""
    rng = np.random.default_rng(seed)
    L, R, K = bricks.shape
    vert = rng.integers(0, 2, (L, R, K, 1, 3)) + CORNERS        # (L,R,K,8,3)
    v = vert[..., 0] * 9 + vert[..., 1] * 3 + vert[..., 2]
    if values is None:
        values = _bf16(rng.normal(size=(L, R, K, 8, F)))
    row_idx = (bricks[..., None] * 27 + v).astype(np.int32)
    # JAX's untouched slots are bf16(0 * g): -0.0 where g < 0
    neg = rng.random((L, R, K, 1, F)) < 0.5
    dense = np.where(neg, np.float32(-0.0), np.float32(0.0)).repeat(27, 3)
    np.put_along_axis(dense, v[..., None].repeat(F, -1), values, axis=3)
    return (torch.tensor(row_idx.reshape(-1)),
            torch.tensor(values.reshape(-1, F)),
            dense.reshape(L, R * K, 27 * F))


def _check_against_jax(bricks, row_idx, rows, dense, Ku):
    """The plain version against JAX `_dedup_rows`, level by level: every
    value bitwise (== on zeros, NaN matches NaN), every destination equal.
    Returns the port's (idx, rows)."""
    L, R, K = bricks.shape
    idx, out = tbd.dedup_rows_plain(row_idx, rows, R, K, Ku)
    idx = idx.numpy().reshape(L, R, Ku, 27)
    out = out.numpy().reshape(L, R, Ku, 27, F)
    assert (idx % 27 == np.arange(27)).all()
    for lvl in range(L):
        j_idx, j_rows = _jdedup(jnp.asarray(bricks[lvl].reshape(-1),
                                            jnp.int32),
                                jnp.asarray(dense[lvl], jnp.bfloat16),
                                R, K, Ku)
        j_rows = np.asarray(j_rows.astype(jnp.float32)).reshape(R, Ku, 27, F)
        assert np.array_equal(out[lvl], j_rows, equal_nan=True)
        np.testing.assert_array_equal(idx[lvl, ..., 0] // 27,
                                      np.asarray(j_idx).reshape(R, Ku))
    return idx, out


# the rays of tests/test_brick_encoding.py::test_dedup_rows_exact_merge:
# three runs, one run, six runs (overflow at Ku = 3)
THREE_RAYS = np.array([[[5, 5, 9, 9, 9, 2], [7, 7, 7, 7, 7, 7],
                        [1, 2, 3, 4, 5, 6]]])


@pytest.mark.parametrize("Ku", [3, 6])
def test_dedup_rows_three_rays_match_jax(Ku):
    row_idx, rows, dense = _case(THREE_RAYS, 0)
    idx, out = _check_against_jax(THREE_RAYS, row_idx, rows, dense, Ku)
    vals = rows.numpy().reshape(3, 6, 8, F)
    # ray 0, run 1 (samples 2-4): the sum of its rows over all vertices
    want = np.zeros((27, F), np.float32)
    np.add.at(want, row_idx.numpy().reshape(3, 6, 8)[0, 2:5] % 27,
              vals[0, 2:5])
    np.testing.assert_allclose(out[0, 0, 1], want, rtol=2 ** -7)
    assert idx[0, 0, :3, 0].tolist() == [5 * 27, 9 * 27, 2 * 27]
    assert (out[0, 1, 1:] == 0).all()           # one run: unused slots 0
    assert idx[0, 2, :, 0].tolist() == [27 * b for b in range(1, Ku + 1)]


def _random_bricks(L, R, K, seed, pool=6):
    """Per ray a random number of runs of random lengths, each run's brick
    drawn from a small pool (distinct from the previous run's, so a brick
    can come back later in the ray: A B A)."""
    rng = np.random.default_rng(seed)
    bricks = np.zeros((L, R, K), np.int64)
    for lvl in range(L):
        for r in range(R):
            n = rng.integers(1, K + 1)
            cuts = np.sort(rng.choice(np.arange(1, K), n - 1, replace=False))
            b, k0 = -1, 0
            for k1 in list(cuts) + [K]:
                b = rng.choice([x for x in range(pool) if x != b])
                bricks[lvl, r, k0:k1] = b + 100 * lvl
                k0 = k1
    return bricks


@pytest.mark.parametrize("Ku", [2, 4, 8])
def test_dedup_rows_random_runs_match_jax(Ku):
    """R = 64 rays of K = 8 samples at two levels, random runs."""
    bricks = _random_bricks(2, 64, 8, seed=Ku)
    row_idx, rows, dense = _case(bricks, Ku)
    _check_against_jax(bricks, row_idx, rows, dense, Ku)
    # some rays overflow Ku = 2 and 4; none overflow Ku = K
    runs = 1 + (bricks[..., 1:] != bricks[..., :-1]).sum(-1)
    assert (runs > Ku).any() == (Ku < 8)


def test_dedup_rows_hash_collision_and_returning_brick():
    """Two bricks that hash to one row are one run (their vertices share
    the row's slots); a brick that comes back after another (A B A) is
    three runs."""
    bricks = np.array([[[3, 3, 3, 3], [3, 4, 3, 3]]])
    row_idx, rows, dense = _case(bricks, 1)
    idx, out = _check_against_jax(bricks, row_idx, rows, dense, 4)
    assert idx[0, 0, :, 0].tolist() == [81, 81, 81, 81]
    assert (out[0, 0, 1:] == 0).all()
    assert idx[0, 1, :, 0].tolist() == [81, 108, 81, 81]
    assert (out[0, 1, 3] == 0).all()


def test_dedup_rows_non_finite_match_jax():
    """Non-finite terms follow the reference's prefix formula: an inf at
    sample 0 makes its slot inf in run 0 and NaN in every later run and
    unused slot (inf - inf), at the brick row of the ray's last sample; a
    NaN, a -inf and an inf + -inf pair likewise."""
    bricks = np.array([[[5, 5, 9, 9], [1, 1, 1, 2], [4, 6, 6, 8],
                        [2, 2, 2, 2]]])
    rng = np.random.default_rng(3)
    vals = _bf16(rng.normal(size=(1, 4, 4, 8, F)))
    vals[0, 0, 0, 2, 5] = np.inf
    vals[0, 1, 1, 0, 0] = np.nan
    vals[0, 2, 2, 7, 3] = -np.inf
    vals[0, 3, 0, 4, 1] = np.inf
    vals[0, 3, 3, 4, 1] = -np.inf
    row_idx, rows, dense = _case(bricks, 4, vals)
    idx, out = _check_against_jax(bricks, row_idx, rows, dense, 4)
    # ray 0: runs [5, 9], then two unused slots at the last sample's brick
    assert idx[0, 0, :, 0].tolist() == [5 * 27, 9 * 27, 9 * 27, 9 * 27]
    v = row_idx.numpy().reshape(4, 4, 8)[0, 0, 2] % 27
    assert out[0, 0, 0, v, 5] == np.inf
    assert np.isnan(out[0, 0, 1:, v, 5]).all()
    # the NaN slot is NaN in its run and after it; other slots finite
    assert np.isfinite(np.delete(out[0, 0].reshape(4, -1), v * F + 5,
                                 axis=1)).all()
    # ray 3: one run whose slot took inf then -inf: NaN, then NaN - NaN
    v3 = row_idx.numpy().reshape(4, 4, 8)[3, 0, 4] % 27
    assert np.isnan(out[0, 3, :, v3, 1]).all()


def test_dedup_rows_scatter_matches_jax():
    """The deduped rows scattered into the table gradient: the port's K9
    plain version against JAX's f32 `.at[].add` of its own deduped rows."""
    R, K, Ku, n_rows = 64, 8, 4, 700
    bricks = _random_bricks(1, R, K, seed=9, pool=n_rows // 27 - 1)
    row_idx, rows, dense = _case(bricks, 9)
    idx, out = tbd.dedup_rows_plain(row_idx, rows, R, K, Ku)
    got = tsa.scatter_accumulate_plain(idx, out, n_rows * 27).numpy()
    j_idx, j_rows = _jdedup(jnp.asarray(bricks[0].reshape(-1), jnp.int32),
                            jnp.asarray(dense[0], jnp.bfloat16), R, K, Ku)
    ref = np.asarray(jnp.zeros((n_rows, 27 * F)).at[j_idx].add(
        j_rows.astype(jnp.float32))).reshape(-1, F)
    abs_sum = tsa.scatter_accumulate_plain(idx, out.abs(), n_rows * 27)
    count = tsa.scatter_accumulate_plain(idx, torch.ones_like(out),
                                         n_rows * 27)
    assert (np.abs(got - ref) <= (count * U * abs_sum).numpy()).all()
    assert np.abs(ref).max() > 0


def test_dedup_rows_guards():
    """Shapes that do not fit raise; a group of no rays gives no rows; a
    tensor off the CPU goes to the kernel or raises."""
    row_idx, rows, _ = _case(THREE_RAYS, 0)
    with pytest.raises(ValueError):
        tbd.dedup_rows(row_idx, rows, 3, 6, 7)          # Ku > K
    with pytest.raises(ValueError):
        tbd.dedup_rows(row_idx, rows, 4, 6, 3)          # not L x R x K x 8
    idx, out = tbd.dedup_rows(row_idx[:0], rows[:0], 0, 6, 3)
    assert idx.shape == (0,) and out.shape == (0, F)
    with pytest.raises(ValueError):
        tbd.dedup_rows(torch.empty(8 * 6 * 3, dtype=torch.int32,
                                   device="meta"),
                       torch.empty(8 * 6 * 3, F, device="meta"), 3, 6, 3)
    assert build.LAUNCHES["band_dedup"] == 0
    assert tbe.dedup_rows_plain is tbd.dedup_rows_plain
    # encode_multi: one dedup entry a set, R x K points a deduped set
    ts = tbe.make_spec(**LADDER)
    table = torch.zeros(ts.total_rows, ts.row_dim)
    pts = torch.rand(12, 3)
    with pytest.raises(ValueError):
        tbe.encode_multi(table, [pts], ts, [(1, 2)], dedup=[None, None])
    with pytest.raises(ValueError):
        tbe.encode_multi(table, [pts], ts, [(1, 2)], dedup=[(5, 2, 2)])


# ---------------------------------------------------------------- encode

@pytest.mark.parametrize("Ku", [2, 5])
def test_encode_multi_dedup_matches_jax(Ku):
    """A coarse set and a band set of R rays x K z-ordered samples whose
    rows are deduped: table and point gradients against JAX."""
    js, ts = jbe.make_spec(**LADDER), tbe.make_spec(**LADDER)
    rng = np.random.default_rng(Ku)
    table = rng.uniform(-0.3, 0.3, (ts.total_rows, ts.row_dim)).astype(
        np.float32)
    R, K = 30, 5
    o = rng.uniform(0.2, 0.8, (R, 1, 3))
    d = rng.normal(size=(R, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    band = (o + d * np.linspace(0.0, 0.08, K)[None, :, None]).reshape(-1, 3)
    pts = [rng.uniform(0, 1, (200, 3)).astype(np.float32),
           band.astype(np.float32)]
    groups = [(0,), (1, 2)]
    dd = [None, (R, K, Ku)]
    gs = [rng.normal(size=(p.shape[0], len(lv) * F)).astype(np.float32)
          for p, lv in zip(pts, groups)]
    _, vjp = jax.vjp(
        lambda t, *p: jbe.encode_multi(t, p, js, groups, dedup=dd),
        jnp.asarray(table), *(jnp.asarray(p) for p in pts))
    jg = [np.asarray(x) for x in jax.jit(vjp)(
        tuple(jnp.asarray(g) for g in gs))]

    t_table = torch.tensor(table, requires_grad=True)
    t_pts = [torch.tensor(p, requires_grad=True) for p in pts]
    outs = tbe.encode_multi(t_table, t_pts, ts, groups, dedup=dd)
    plain = tbe.encode_multi(t_table, t_pts, ts, groups)
    for a, b in zip(outs, plain):
        assert torch.equal(a, b)
    torch.autograd.backward(outs, [torch.tensor(g) for g in gs])
    _, ri0, rv0 = tbe.encode_bwd_plain(t_table.detach(), t_pts[0].detach(),
                                       torch.tensor(gs[0]), ts, groups[0])
    _, ri1, rv1 = tbe.encode_bwd_plain(t_table.detach(), t_pts[1].detach(),
                                       torch.tensor(gs[1]), ts, groups[1])
    ri1, rv1 = tbe.dedup_rows_plain(ri1, rv1, R, K, Ku)
    idx, rows = torch.cat([ri0, ri1]), torch.cat([rv0, rv1])
    T = ts.total_rows * 27
    tol = (tsa.scatter_accumulate_plain(idx, torch.ones_like(rows), T) * U
           * tsa.scatter_accumulate_plain(idx, rows.abs(), T))
    err = np.abs(t_table.grad.numpy() - jg[0])
    assert (err <= tol.view(ts.total_rows, -1).numpy()).all()
    for tp, ref in zip(t_pts, jg[1:]):
        np.testing.assert_allclose(tp.grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())


# ---------------------------------------------------------------- queries

@pytest.mark.parametrize("query,dedup", [
    ("lod", 0.5), ("lod", 1.0), ("lod_mid", 0.5), ("lod_field", 0.5),
    ("lod_field", 1.0)])
def test_dedup_queries_match_jax(query, dedup, monkeypatch):
    """query_lod (also with n_mid > 0) and query_lod_field with `dedup`:
    values equal to the port's no-dedup values; values and gradients of
    every parameter leaf and of the points against JAX's with the same
    `dedup`."""
    w = BrickWorld(seed=1)
    jsc, tsc = w.jsc, w.tsc
    R, S, K = 24, 14, N_FINE
    rng = np.random.default_rng(2)
    # rays through the volume, samples in z order
    o = rng.uniform(0.1, 0.9, (R, 1, 3))
    d = rng.normal(size=(R, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = (o + d * np.linspace(0.0, 0.3, S)[None, :, None]).astype(np.float32)
    sel = _selection(R, S, K, 3)
    onehot = jnp.asarray(sel[..., None] == np.arange(S)[None, None, :])
    g = rng.normal(size=(R, S, 4)).astype(np.float32)
    kw = {"lod": {}, "lod_mid": {"split": "hashed", "n_mid": 2},
          "lod_field": {"split": "coarse2"}}[query]

    def jfn(prm, x):
        if query == "lod_field":
            return jscene.query_lod_field(prm, jsc, x, K, dedup=dedup, **kw)
        return jscene.query_lod(prm, jsc, x, onehot, dedup=dedup, **kw)

    def tfn(prm, x, dd):
        if query == "lod_field":
            return tscene.query_lod_field(prm, tsc, x, K, dedup=dd, **kw)
        return tscene.query_lod(prm, tsc, x, torch.tensor(sel).long(),
                                dedup=dd, **kw)

    ref, (jg_tree, jg_p) = jax.jit(
        lambda prm, x: (lambda o, vjp: (o, vjp(jnp.asarray(g))))(
            *jax.vjp(jfn, prm, x)))(w.tree, jnp.asarray(p))
    params = _trainable(w.tree)
    tp = torch.tensor(p, requires_grad=True)
    with torch.no_grad():
        plain = tfn(params, tp, 0.0)
    calls = _record_table_rows(monkeypatch)
    out = tfn(params, tp, dedup)
    assert torch.equal(out, plain)
    out.backward(torch.tensor(g))
    _close(out.detach(), ref)
    _grad_close(tp.grad, jg_p)
    _check_tree_grads(params, jg_tree, _table_tol(calls, tsc.brick_spec))
    # the band rows reach the scatter deduped: Ku x 27 rows a ray a level
    coarse, fine = tbe.coarse_fine_split(tsc.brick_spec,
                                         kw.get("split", "cost"))
    bands = [(fine[:-1], 2), (fine[-1:], K)] if query == "lod_mid" \
        else [(fine, K)]
    want = R * S * 8 * len(coarse) + sum(
        len(lv) * R * min(k, max(2, int(np.ceil(k * dedup)))) * 27
        for lv, k in bands)
    assert sum(idx.numel() for idx, _ in calls) == want
