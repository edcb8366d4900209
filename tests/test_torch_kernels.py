"""Port parity for the kernels of `unislam_tpu_torch`: the hash-grid encode
forward (K1) and backward (K2) and the sorted scatter-accumulate (K9), in
their plain PyTorch versions (what tensors on the CPU run), against the JAX
package's `hash_encoding.encode` and the Pallas `scatter_accumulate`.

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
    representable updates, so its bf16 cast is lossless; both accumulate in
    f32, so they agree with an f64 sum to f32 round-off."""
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
    assert set(build.SOURCES) == {"hash_encode", "brick_encode",
                                  "scatter_accum"}
    assert all((build.CSRC / f"{name}.cu").exists() for name in build.SOURCES)
