"""Port parity for the kernels of `unislam_tpu_torch`: the hash-grid encode
forward (K1) and backward (K2) and the order-independent fixed-point
scatter-accumulate (K9), in their plain PyTorch versions (what tensors on
the CPU run), against the JAX package's `hash_encoding.encode` and the
Pallas `scatter_accumulate`, and K9's numerics against an independent
numpy transcription and their stated bound.

Tolerances (all f32):
- features: |diff| <= 1e-6 * sum_k w_k |f_k| (the same 8 rounded products,
  summed in another order or with fused multiply-adds);
- corner rows: exact; gradient rows w*g: rtol 1e-6;
- table gradient: |diff| <= 1e-6 * per-row sum of |rows| (two f32 sums of
  the same updates);
- point gradient: rtol 1e-5 plus 1e-6 of its largest magnitude (a 4-level
  sum with cancellation).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from unislam_tpu.models import hash_encoding as jhe
from unislam_tpu_torch.kernels import build
from unislam_tpu_torch.kernels import scatter_accum as tsa
from unislam_tpu_torch.models import hash_encoding as the

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 4 levels: resolutions 4 and 11 are dense, 26 and 64 are hashed into 2^12
SPEC_ARGS = dict(n_levels=4, n_features=2, log2_hashmap_size=12,
                 base_resolution=4, desired_resolution=64)


def _specs():
    return jhe.make_spec(**SPEC_ARGS), the.make_spec(**SPEC_ARGS)


def _points(n=600, seed=0):
    """Uniform points, points outside [0, 1], and points on cell faces
    (p * scale + 0.5 an integer at some level)."""
    rng = np.random.default_rng(seed)
    spec = the.make_spec(**SPEC_ARGS)
    pts = [rng.uniform(0.0, 1.0, (n, 3)),
           rng.uniform(-0.2, 1.2, (n // 4, 3))]
    for s in spec.scales:
        k = rng.integers(1, int(s), (n // 8, 3))
        pts.append((k - 0.5) / float(s))
    pts.append(np.array([[0.0, 1.0, 0.5], [1.0, 0.0, 0.0], [0.5, 0.5, 0.5]]))
    return np.concatenate(pts).astype(np.float32)


def _table(spec, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (spec.total_entries, 2)).astype(np.float32)


def test_make_spec_matches_jax():
    for args in (SPEC_ARGS, dict(log2_hashmap_size=16, desired_resolution=755),
                 dict(log2_hashmap_size=19, desired_resolution=755)):
        js, ts = jhe.make_spec(**args), the.make_spec(**args)
        assert js.per_level_scale == ts.per_level_scale
        for name in ("scales", "resolutions", "offsets", "hashed",
                     "level_sizes"):
            np.testing.assert_array_equal(getattr(js, name),
                                          getattr(ts, name))
    js, ts = _specs()
    assert list(ts.hashed) == [False, False, True, True]


def test_encode_forward_matches_jax():
    js, ts = _specs()
    table, pts = _table(js), _points()
    ref = np.asarray(jhe.encode(jnp.asarray(table), jnp.asarray(pts), js))
    out = the.encode(torch.tensor(table), torch.tensor(pts), ts).numpy()
    assert out.shape == (pts.shape[0], ts.out_dim)
    ref_abs = the.encode(torch.tensor(np.abs(table)), torch.tensor(pts),
                         ts).numpy()
    err = np.abs(out - ref)
    assert (err <= 1e-6 * ref_abs).all(), err.max()


def test_encode_gradients_match_jax_vjp():
    js, ts = _specs()
    table, pts = _table(js), _points()
    g = np.random.default_rng(2).normal(
        size=(pts.shape[0], ts.out_dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda t, p: jhe.encode(t, p, js), jnp.asarray(table),
                     jnp.asarray(pts))
    g_table_ref, g_pts_ref = (np.asarray(x) for x in vjp(jnp.asarray(g)))

    t_table = torch.tensor(table, requires_grad=True)
    t_pts = torch.tensor(pts, requires_grad=True)
    the.encode(t_table, t_pts, ts).backward(torch.tensor(g))

    # per-row sum of |update| bounds the f32 summation-order difference
    _, row_idx, rows = the.encode_bwd_plain(
        torch.tensor(table), torch.tensor(pts), torch.tensor(g), ts,
        need_points=False)
    abs_sum = tsa.scatter_accumulate_plain(row_idx, rows.abs(),
                                           ts.total_entries).numpy()
    err = np.abs(t_table.grad.numpy() - g_table_ref)
    assert (err <= 1e-6 * abs_sum + 1e-12).all(), err.max()

    gp = t_pts.grad.numpy()
    np.testing.assert_allclose(gp, g_pts_ref, rtol=1e-5,
                               atol=1e-6 * np.abs(g_pts_ref).max())
    outside = (pts < 0.0) | (pts > 1.0)
    assert outside.any() and (gp[outside] == 0.0).all()


def test_backward_rows_are_the_reference_order():
    """K2's emitted rows: destinations and w*g in JAX's (L, N, 8) order."""
    js, ts = _specs()
    table, pts = _table(js), _points(200)
    g = np.random.default_rng(3).normal(
        size=(pts.shape[0], ts.out_dim)).astype(np.float32)
    _, res = jhe._encode_fwd(jnp.asarray(table), jnp.asarray(pts), js)
    idx_ref, frac_ref = np.asarray(res[2]), res[3]
    w = jhe._interp_weights(frac_ref)
    gl = jnp.moveaxis(jnp.asarray(g).reshape(-1, 4, 2), 1, 0)
    rows_ref = np.asarray((w[..., None] * gl[:, :, None, :]).reshape(-1, 2))

    g_pts, row_idx, rows = the.encode_bwd_plain(
        torch.tensor(table), torch.tensor(pts), torch.tensor(g), ts,
        need_points=False)
    assert g_pts is None and row_idx.dtype == torch.int32
    np.testing.assert_array_equal(row_idx.numpy(), idx_ref.reshape(-1))
    np.testing.assert_allclose(rows.numpy(), rows_ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("group", ["faces", "bounds", "outside"])
def test_adversarial_points_match_jax(group):
    """The points `chip_smoke.py` holds K1 and K2 to on the card (cell faces
    under the twice-rounded position math, coordinates exactly 0 and 1, and
    just outside [0, 1]) through the plain versions against the JAX
    package's `_encode_fwd` / `_encode_bwd`: the same corner rows, features,
    gradient rows, table and point gradients, the latter 0 at every
    coordinate outside [0, 1].

    JAX runs op by op here: under `jax.jit` XLA's CPU backend contracts
    p * scale + 0.5 into a fused multiply-add, and a few cell-face points
    then take another cell. XLA also flushes subnormals to zero, so it
    counts -1.4e-45 as inside, where the port (like the plain f32 math)
    counts it as outside: its gradient is compared for the port alone."""
    js, ts = _specs()
    adv = chip_smoke.adversarial_points("hash", ts.scales)
    assert adv["fma_flips"] > 0
    pts = adv[group]
    N = pts.shape[0]
    table = _table(js)
    g = np.random.default_rng(12).normal(size=(N, ts.out_dim)).astype(
        np.float32)
    out_ref, res = jhe._encode_fwd(jnp.asarray(table), jnp.asarray(pts), js)
    g_table_ref, g_pts_ref = (np.asarray(x) for x in jhe._encode_bwd(
        js, res, jnp.asarray(g)))
    idx_ref = np.asarray(res[2])                                  # (L,N,8)
    w = jhe._interp_weights(res[3])
    gl = jnp.moveaxis(jnp.asarray(g).reshape(N, ts.n_levels, 2), 1, 0)
    rows_ref = np.asarray((w[..., None] * gl[:, :, None, :]).reshape(-1, 2))

    out = the.encode_fwd_plain(torch.tensor(table), torch.tensor(pts),
                               ts).numpy()
    ref_abs = the.encode_fwd_plain(torch.tensor(np.abs(table)),
                                   torch.tensor(pts), ts).numpy()
    assert (np.abs(out - np.asarray(out_ref)) <= 1e-6 * ref_abs).all()
    g_pts, row_idx, rows = the.encode_bwd_plain(
        torch.tensor(table), torch.tensor(pts), torch.tensor(g), ts)
    np.testing.assert_array_equal(row_idx.numpy(), idx_ref.reshape(-1))
    np.testing.assert_allclose(rows.numpy(), rows_ref, rtol=1e-6, atol=0)
    g_table = tsa.scatter_accumulate_plain(row_idx, rows,
                                           ts.total_entries).numpy()
    abs_sum = tsa.scatter_accumulate_plain(row_idx, rows.abs(),
                                           ts.total_entries).numpy()
    assert (np.abs(g_table - g_table_ref) <= 1e-6 * abs_sum + 1e-12).all()
    gp = g_pts.numpy()
    flushed = (pts != 0.0) & (np.abs(pts) < np.finfo(np.float32).tiny)
    np.testing.assert_allclose(gp[~flushed], g_pts_ref[~flushed], rtol=1e-5,
                               atol=1e-6 * np.abs(g_pts_ref).max())
    outside = (pts < 0.0) | (pts > 1.0)
    assert outside.any() == flushed.any() == (group == "outside")
    assert (gp[outside] == 0.0).all()
    assert (g_pts_ref[outside & ~flushed] == 0.0).all()


def test_frozen_table_forms_no_table_gradient(monkeypatch):
    """Tracking freezes the scene: the backward then emits no table rows
    and never reaches the scatter-accumulate."""
    _, ts = _specs()
    calls = []

    def no_scatter(*a, **k):
        raise AssertionError("scatter_accumulate called for a frozen table")

    real_bwd = the.encode_bwd

    def spy_bwd(table, points, g_out, spec, need_points, need_rows):
        calls.append((need_points, need_rows))
        return real_bwd(table, points, g_out, spec, need_points, need_rows)

    monkeypatch.setattr(the, "scatter_accumulate", no_scatter)
    monkeypatch.setattr(the, "encode_bwd", spy_bwd)
    table = torch.tensor(_table(ts))
    pts = torch.tensor(_points(50), requires_grad=True)
    the.encode(table, pts, ts).sum().backward()
    assert pts.grad is not None and table.grad is None
    assert calls == [(True, False)]


def test_scatter_accumulate_matches_jax_scatter_add():
    rng = np.random.default_rng(4)
    n_rows, M, D = 3000, 5000, 3
    idx = rng.integers(0, n_rows, M).astype(np.int32)
    idx[:10] = n_rows + 5          # out of range: dropped by both
    idx[10:400] = 7                # one long run
    upd = rng.normal(size=(M, D)).astype(np.float32)
    ref = np.asarray(jnp.zeros((n_rows, D), jnp.float32).at[
        jnp.asarray(idx)].add(jnp.asarray(upd)))
    out = tsa.scatter_accumulate(torch.tensor(idx), torch.tensor(upd), n_rows)
    abs_sum = np.zeros((n_rows, D))
    keep = idx < n_rows
    np.add.at(abs_sum, idx[keep], np.abs(upd[keep]))
    err = np.abs(out.numpy() - ref)
    assert (err <= 1e-6 * abs_sum + 1e-12).all(), err.max()
    untouched = np.setdiff1d(np.arange(n_rows), idx[keep])
    assert (out.numpy()[untouched] == 0.0).all()
    again = tsa.scatter_accumulate(torch.tensor(idx), torch.tensor(upd),
                                   n_rows)
    assert torch.equal(out, again)


def test_scatter_accumulate_matches_pallas_kernel():
    """Against the Pallas kernel itself (interpret mode) on bf16-
    representable updates, so its bf16 cast is lossless; it accumulates in
    f32 and K9 in fixed point, so both agree with an f64 sum to f32
    round-off."""
    from jax.experimental.pallas import tpu as pltpu
    path = os.path.join(REPO, "examples", "pallas_scatter_accum.py")
    spec = importlib.util.spec_from_file_location("pallas_scatter_accum",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    rng = np.random.default_rng(5)
    n_rows, M, D = 3000, 5000, 2
    idx = rng.integers(0, n_rows, M).astype(np.int32)
    upd = np.asarray(jnp.asarray(rng.normal(size=(M, D)), jnp.bfloat16)
                     .astype(jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(mod.scatter_accumulate(jnp.asarray(idx),
                                                jnp.asarray(upd), n_rows))
    out = tsa.scatter_accumulate(torch.tensor(idx), torch.tensor(upd),
                                 n_rows).numpy()
    exact = np.zeros((n_rows, D))
    np.add.at(exact, idx, upd.astype(np.float64))
    abs_sum = np.zeros((n_rows, D))
    np.add.at(abs_sum, idx, np.abs(upd.astype(np.float64)))
    tol = 1e-6 * abs_sum + 1e-12
    assert (np.abs(out - exact) <= tol).all()
    assert (np.abs(ref - exact) <= tol).all()
    assert (np.abs(out - ref) <= 2 * tol).all()


# ------------------------------------------------- K9's fixed-point numerics

def _fixed_point_reference(idx, upd, n_rows):
    """K9's numerics in numpy, from other primitives than the plain version
    (bit fields for the exponent, np.ldexp for the scaling)."""
    keep = (idx >= 0) & (idx < n_rows)
    idx, upd = idx[keep].astype(np.int64), upd[keep]
    bits = (upd.view(np.int32) & 0x7FFFFFFF).max(1)
    top = np.zeros(n_rows, np.int32)
    np.maximum.at(top, idx, bits)
    count = np.bincount(idx, minlength=n_rows)
    biased, mant = top >> 23, top & 0x7FFFFF
    e = np.where(biased > 0, biased - 126,
                 np.array([int(x).bit_length() for x in mant]) - 149)
    h = np.array([int(max(c - 1, 0)).bit_length() for c in count])
    s = 62 - e - h
    q = np.rint(np.ldexp(upd.astype(np.float64), s[idx][:, None]))
    acc = np.zeros((n_rows, upd.shape[1]), np.int64)
    np.add.at(acc, idx, q.astype(np.int64))
    out = np.ldexp(acc.astype(np.float64), -s[:, None]).astype(np.float32)
    out[top >= 0x7F800000] = np.nan
    return out, top, count, e, h


def _exact_sums(idx, upd, n_rows):
    """Per (destination, column) math.fsum of the terms: the exact sum,
    rounded once to f64."""
    import math
    out = np.zeros((n_rows, upd.shape[1]))
    order = np.argsort(idx, kind="stable")
    heads, starts = np.unique(idx[order], return_index=True)
    for k, a, b in zip(heads, starts, list(starts[1:]) + [len(idx)]):
        for c in range(upd.shape[1]):
            out[k, c] = math.fsum(upd[order[a:b], c].astype(np.float64))
    return out


def _assert_within_bound(idx, upd, n_rows, out):
    """|out - exact| <= 1 f32 ulp + c_k * 2^(e_k + h_k - 63) (K9's bound),
    plus the exact sum's own rounding to f64."""
    _, _, count, e, h = _fixed_point_reference(idx, upd, n_rows)
    exact = _exact_sums(idx, upd, n_rows)
    ulp = np.spacing(np.maximum(np.abs(exact), np.abs(out)).astype(
        np.float32)).astype(np.float64)
    bound = ulp + np.ldexp(count.astype(np.float64), e + h - 63)[:, None]
    err = np.abs(out.astype(np.float64) - exact)
    assert (err <= bound + 2.0 ** -52 * np.abs(exact)).all(), \
        (err / bound).max()


def test_scatter_accumulate_equals_numpy_fixed_point_bitwise():
    """The plain version against an independent numpy transcription of the
    numerics, on normal, subnormal, zero and out-of-range terms."""
    rng = np.random.default_rng(6)
    n_rows, M, D = 400, 6000, 3
    idx = rng.integers(0, n_rows, M).astype(np.int32)
    idx[:7] = [-1, n_rows, n_rows + 5, -3, n_rows, -1, n_rows]
    idx[100:2100] = 9
    upd = (rng.normal(size=(M, D))
           * np.exp2(rng.integers(-40, 40, (M, 1)))).astype(np.float32)
    sub = idx == 17            # subnormal terms only
    upd[sub] = (rng.integers(1, 2 ** 23, (sub.sum(), D))
                * 2.0 ** -149).astype(np.float32)
    upd[idx == 23] = 0.0
    ref, top, *_ = _fixed_point_reference(idx, upd, n_rows)
    assert (top[17] >> 23) == 0 and top[17] > 0        # subnormal max
    # torch.frexp's exponent on the subnormal max agrees with the bit field
    _, e_t = torch.frexp(torch.tensor(top[17:18]).view(torch.float32)
                         .double())
    assert int(e_t) == int(top[17]).bit_length() - 149
    out = tsa.scatter_accumulate(torch.tensor(idx), torch.tensor(upd),
                                 n_rows).numpy()
    assert out.view(np.int32).tolist() == ref.view(np.int32).tolist()
    assert (out[23] == 0.0).all() and (out[17] != 0.0).any()


def test_scatter_accumulate_is_bitwise_order_independent():
    rng = np.random.default_rng(7)
    n_rows, M, D = 2000, 30000, 2
    idx = rng.integers(0, n_rows, M).astype(np.int32)
    idx[:20000] = 11                                   # one long run
    upd = rng.normal(size=(M, D)).astype(np.float32)
    perm = rng.permutation(M)
    out = tsa.scatter_accumulate(torch.tensor(idx), torch.tensor(upd),
                                 n_rows)
    out_p = tsa.scatter_accumulate(torch.tensor(idx[perm]),
                                   torch.tensor(upd[perm]), n_rows)
    assert torch.equal(out, out_p)
    rev = np.ascontiguousarray(upd[::-1])
    assert torch.equal(out, tsa.scatter_accumulate(
        torch.tensor(idx[::-1].copy()), torch.tensor(rev), n_rows))


def test_scatter_accumulate_within_bound_over_wide_magnitudes():
    """A run of 20,000 rows, and destinations whose terms lie at
    magnitudes from 2^-60 to 2^60 (one destination mixes them all)."""
    rng = np.random.default_rng(8)
    n_rows, D = 300, 2
    idx = [np.full(20000, 5)]
    upd = [rng.normal(size=(20000, D))]
    for k, p in enumerate(range(-60, 61, 10)):
        n = int(rng.integers(1, 50))
        idx.append(np.full(n, 20 + k))
        upd.append(rng.normal(size=(n, D)) * 2.0 ** p)
    mixed = rng.normal(size=(400, D)) * np.exp2(rng.integers(-60, 61,
                                                             (400, 1)))
    idx.append(np.full(400, 50))
    upd.append(mixed)
    idx.append(rng.integers(0, n_rows, 3000))
    upd.append(rng.normal(size=(3000, D)))
    idx = np.concatenate(idx).astype(np.int32)
    upd = np.concatenate(upd).astype(np.float32)
    out = tsa.scatter_accumulate(torch.tensor(idx), torch.tensor(upd),
                                 n_rows).numpy()
    _assert_within_bound(idx, upd, n_rows, out)


def test_scatter_accumulate_small_terms_beside_zeros():
    """Exact zeros do not coarsen a destination's scale: 1e-10 terms among
    thousands of zeros keep their bound."""
    rng = np.random.default_rng(9)
    n_rows, D = 50, 4
    idx = np.repeat(np.arange(4), [5000, 3000, 10, 1]).astype(np.int32)
    upd = (rng.normal(size=(idx.size, D)) * 1e-10).astype(np.float32)
    upd[rng.random(idx.size) < 0.8] = 0.0
    upd[idx == 3] = 0.0                                  # zeros only
    out = tsa.scatter_accumulate(torch.tensor(idx), torch.tensor(upd),
                                 n_rows).numpy()
    _assert_within_bound(idx, upd, n_rows, out)
    assert (out[3] == 0.0).all() and (out[4:] == 0.0).all()
    assert np.abs(out[0]).max() > 1e-10


def test_scatter_accumulate_non_finite_and_overflow():
    """Each column sums by IEEE rules, as the reference's `.at[idx].add`:
    a NaN term makes that column NaN, infinite terms of one sign make it
    +-inf, +inf with -inf makes it NaN; the other columns keep their sums.
    A sum beyond the f32 range is +-inf. Held against JAX's `.at[].add` on
    the same rows (order-independent for these inputs) and bitwise equal
    across row orders."""
    idx = np.array([0, 0, 1, 1, 2, 2, 2, 3, 3, 3, 4, 5, 5, 5, 6, 6],
                   np.int32)
    big = 3.0e38
    inf, nan = np.inf, np.nan
    upd = np.array([[1.0, nan], [2.0, 3.0], [inf, 1.0], [1.0, 1.0],
                    [big, -big], [big, -big], [big, -big],
                    [big, 2.0 ** 100], [-big, 2.0 ** 101], [big, 2.0 ** 102],
                    [0.5, -0.25],
                    [inf, 1.0], [-inf, 2.0], [3.0, -inf],
                    [-inf, big], [-inf, big]],
                   np.float32)
    n_rows = 8
    out = tsa.scatter_accumulate(torch.tensor(idx), torch.tensor(upd),
                                 n_rows).numpy()
    ref = np.asarray(jnp.zeros((n_rows, 2), jnp.float32).at[
        jnp.asarray(idx)].add(jnp.asarray(upd)))
    np.testing.assert_array_equal(out, ref)
    assert out[0, 0] == 3.0 and np.isnan(out[0, 1])
    assert out[1].tolist() == [inf, 2.0]
    assert out[2, 0] == inf and out[2, 1] == -inf
    assert out[3].tolist() == [float(np.float32(big)), 7 * 2.0 ** 100]
    assert out[4].tolist() == [0.5, -0.25]
    assert np.isnan(out[5, 0]) and out[5, 1] == -inf
    assert out[6].tolist() == [-inf, inf]
    assert (out[7] == 0.0).all()
    for seed in range(3):
        perm = np.random.default_rng(seed).permutation(len(idx))
        again = tsa.scatter_accumulate(torch.tensor(idx[perm]),
                                       torch.tensor(upd[perm]), n_rows)
        assert torch.equal(again.view(torch.int32),
                           torch.tensor(out).view(torch.int32))


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is never taken for it (meta tensors stand in for a device
    without the kernel)."""
    _, ts = _specs()
    table = torch.empty(ts.total_entries, 2, device="meta")
    pts = torch.empty(10, 3, device="meta")
    with pytest.raises(ValueError):
        the.encode_fwd(table, pts, ts)
    with pytest.raises(ValueError):
        the.encode_bwd(table, pts, torch.empty(10, 8, device="meta"), ts)
    with pytest.raises(ValueError):
        tsa.scatter_accumulate(torch.empty(10, dtype=torch.int32,
                                           device="meta"),
                               torch.empty(10, 2, device="meta"), 5)
    with pytest.raises(ValueError):   # mixed CPU / other device
        the.encode_fwd(torch.zeros(ts.total_entries, 2), pts, ts)


def test_failed_build_raises(monkeypatch, tmp_path):
    """Without a CUDA compiler the build raises; nothing falls back."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library("scatter_accum")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library("brick_encode")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library("fused_mlp")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library("band_dedup")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library("composite")
    assert set(build.SOURCES) == {"hash_encode", "brick_encode",
                                  "scatter_accum", "fused_mlp", "adam_lp",
                                  "band_dedup", "composite"}
    assert all((build.CSRC / f"{name}.cu").exists() for name in build.SOURCES)
