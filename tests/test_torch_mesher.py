"""The port's meshing path against the JAX package's: the native library
copy (marching tetrahedra, frustum masks, depth rasterizer) bitwise, PLY
IO, the mesher's SDF grid on carried parameters (dense, hash hierarchical,
brick LOD two-pass), the extracted mesh, `scene_bound_from_bank` and
`cull_mesh`.

Tolerances: SDF values rtol 1e-5 / atol 1e-6 (the JAX query is jitted;
XLA may contract multiply-adds); mesh vertices 2e-3 of the grid spacing
(a vertex interpolates along a grid edge, dividing the SDF difference by
the edge's SDF change), faces exactly; vertex colours within 1 of 255.
"""

import os

import jax
import numpy as np
import pytest
import torch

from unislam_tpu.core.rays import Intrinsics as JIntrinsics
from unislam_tpu.data.synthetic import SyntheticRoom, make_config
from unislam_tpu.engine import keyframes as jkf
from unislam_tpu.models import scene as jscene
from unislam_tpu.native import lib as jnative
from unislam_tpu.tools.cull_mesh import cull_mesh as jcull
from unislam_tpu.utils import mesh_io as jmesh_io
from unislam_tpu.utils.mesher import Mesher as JMesher
from unislam_tpu_torch.core.rays import Intrinsics
from unislam_tpu_torch.engine import keyframes as tkf
from unislam_tpu_torch.models import scene as tscene
from unislam_tpu_torch.tools.cull_mesh import cull_mesh as tcull
from unislam_tpu_torch.utils import mesh_io, native
from unislam_tpu_torch.utils.mesher import GridPoints
from unislam_tpu_torch.utils.mesher import Mesher as TMesher

INTR = (40, 40, 35.0, 35.0, 19.5, 19.5)
CUBE = [[-1.3, -0.1], [-0.5, 0.55], [-0.45, 0.5]]   # pokes out at x < -1.2


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------- native

def test_native_copy_is_bitwise_the_jax_library():
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(19, 23, 17)).astype(np.float32)
    for level in (0.0, 0.3):
        for a, b in zip(native.marching_tetrahedra(grid, level),
                        jnative.marching_tetrahedra(grid, level)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    verts, faces = native.marching_tetrahedra(grid, 0.0)
    verts = verts / 10.0 - 1.0
    c2w = np.eye(4)
    c2w[:3, 3] = [0.1, -0.2, 3.0]
    w2c = np.linalg.inv(c2w)
    args = (w2c, 30.0, 31.0, 15.5, 11.5, 32, 24)
    np.testing.assert_array_equal(native.rasterize_depth(verts, faces, *args),
                                  jnative.rasterize_depth(verts, faces,
                                                          *args))
    depth = rng.uniform(2.0, 4.0, (24, 32)).astype(np.float32)
    for d, trunc in ((None, 0.0), (depth, 0.1)):
        np.testing.assert_array_equal(
            native.frustum_visibility(verts, *args, depth_img=d,
                                      trunc=trunc),
            jnative.frustum_visibility(verts, *args, depth_img=d,
                                       trunc=trunc))


def test_native_library_builds_under_build_only():
    """The port builds its own copy into build/native (keyed by source and
    flags) and leaves the JAX package's library alone."""
    jax_lib = os.path.join(os.path.dirname(jnative.__file__), "..", "..",
                           "native", "libunislam_native.so")
    before = open(jax_lib, "rb").read() if os.path.exists(jax_lib) else None
    path = native.library_path()
    native.get_lib()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert native._SRC.parts[-3:] == ("unislam_tpu_torch", "csrc",
                                      "marching.cpp")
    after = open(jax_lib, "rb").read() if os.path.exists(jax_lib) else None
    assert before == after


def test_failed_native_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native._build()


# ---------------------------------------------------------------- PLY

@pytest.mark.parametrize("with_color", [False, True])
def test_ply_round_trip_matches_jax(tmp_path, with_color):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    f = rng.integers(0, 50, (70, 3))
    c = rng.random((50, 3)) if with_color else None
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    mesh_io.write_ply(a, v, f, c)
    jmesh_io.write_ply(b, v, f, c)
    assert open(a, "rb").read() == open(b, "rb").read()
    for x, y in zip(mesh_io.read_ply(a), jmesh_io.read_ply(a)):
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)
    vv, ff, cc = mesh_io.read_ply(a)
    np.testing.assert_array_equal(vv, v)
    np.testing.assert_array_equal(ff, f)
    ascii_ply = tmp_path / "c.ply"
    ascii_ply.write_text(
        "ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
        "property float y\nproperty float z\nelement face 1\n"
        "property list uchar int vertex_indices\nend_header\n"
        "0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    for x, y in zip(mesh_io.read_ply(str(ascii_ply)),
                    jmesh_io.read_ply(str(ascii_ply))):
        assert (x is None and y is None) or np.array_equal(x, y)
    rv, rf, rc = mesh_io.remove_unreferenced(v, f[:5], c)
    jv, jf, jc = jmesh_io.remove_unreferenced(v, f[:5], c)
    np.testing.assert_array_equal(rv, jv)
    np.testing.assert_array_equal(rf, jf)


# ---------------------------------------------------------------- mesher

def _hash_setup(resolution, seed=0, **meshing):
    ds = SyntheticRoom(n_frames=2)
    cfg = make_config(ds, {
        "meshing": {"resolution": resolution, **meshing},
        "grid": {"hash_size_sdf": 10, "hash_size_color": 10},
        "mapping": {"marching_cubes_bound": CUBE}})
    return cfg, _params(cfg, seed)


def _brick_setup(resolution, seed=0):
    ds = SyntheticRoom(n_frames=2)
    cfg = make_config(ds, {
        "rendering": {"n_fine": 8, "lod_split": "hashed"},
        "meshing": {"resolution": resolution},
        "mapping": {"marching_cubes_bound": CUBE},
        "grid": {"encoding": "brick", "brick_levels": 3,
                 "brick_base_res": 8, "brick_features": 4,
                 "brick_hash_size": 10, "brick_matmul_rows": 512,
                 "brick_matmul_hashed": 0}})
    return cfg, _params(cfg, seed)


def _params(cfg, seed):
    """JAX-initialised parameters with tables widened from the +-1e-4 init
    so the field has structure, and the SDF head's last bias set so the
    level set 0 crosses the grid."""
    sc = jscene.make_scene_config(cfg)
    tree = jax.tree_util.tree_map(
        np.asarray, jscene.init_params(jax.random.PRNGKey(seed), sc))
    rng = np.random.default_rng(seed)
    for k in ("sdf_table", "color_table", "table"):
        if k in tree:
            tree[k] = rng.uniform(-1.0, 1.0, tree[k].shape).astype(
                tree[k].dtype)
    return tree


def _meshers(cfg, tree, batch=4096):
    jsc = jscene.make_scene_config(cfg)
    tsc = tscene.make_scene_config(cfg)
    jm = JMesher(cfg, jsc, JIntrinsics(*INTR), points_batch_size=batch)
    tm = TMesher(cfg, tsc, Intrinsics(*INTR), points_batch_size=batch)
    tp = tscene.params_from_jax(tree, device="cpu")
    # level set at the field's median over the grid: a surface crosses it
    axes = tm.grid_axes()
    sdf = tm.eval_points(GridPoints(axes, "cpu"), tp, sdf_only=True)
    level = float(np.median(sdf))
    jm.level_set = tm.level_set = level
    return jm, tm, tp


def _jax_grid(jm):
    axes = jm.grid_axes()
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    return axes, np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)


def test_grid_points_are_the_jax_meshgrid():
    cfg, tree = _hash_setup(0.07)
    jm, tm, _ = _meshers(cfg, tree)
    axes, pts = _jax_grid(jm)
    g = GridPoints(axes, "cpu")
    assert len(g) == len(pts)
    np.testing.assert_array_equal(g[0:len(g)].numpy(),
                                  pts.astype(np.float32))
    idx = np.random.default_rng(0).choice(len(pts), 300, replace=False)
    np.testing.assert_array_equal(g.take(idx)[0:300].numpy(),
                                  pts[idx].astype(np.float32))
    np.testing.assert_array_equal(g.take(idx)[100:250].numpy(),
                                  pts[idx[100:250]].astype(np.float32))


@pytest.mark.parametrize("sdf_only", [True, False])
def test_dense_grid_matches_jax(sdf_only):
    cfg, tree = _hash_setup(0.08)
    jm, tm, tp = _meshers(cfg, tree, batch=3000)
    axes, pts = _jax_grid(jm)
    ref = jm.eval_points(pts, tree, sdf_only=sdf_only)
    out = tm.eval_points(GridPoints(axes, "cpu"), tp, sdf_only=sdf_only)
    _close(out, ref)
    # out-of-bound points get sdf = -1
    assert (np.asarray(ref).reshape(len(pts), -1)[:, -1] == -1.0).any()
    # the same through a host array (vertex colours take this path)
    _close(tm.eval_points(pts[:500], tp, sdf_only=sdf_only),
           np.asarray(ref)[:500])


def test_hash_hierarchical_grid_matches_jax():
    cfg, tree = _hash_setup(0.03)
    jm, tm, tp = _meshers(cfg, tree)
    assert jm._hier_two_pass and tm._hier_two_pass
    assert tm._hier_stride == jm._hier_stride == 2
    axes, pts = _jax_grid(jm)
    shape = tuple(len(a) for a in axes)
    ref = jm._eval_grid_hierarchical(pts, tree, shape, False)
    out = tm._eval_grid_hierarchical(GridPoints(axes, "cpu"), tp, shape)
    _close(out, ref)
    assert 0 < tm.stats["fine_points"] < len(pts)


def test_brick_lod_two_pass_grid_matches_jax(monkeypatch):
    cfg, tree = _brick_setup(0.06)
    jm, tm, tp = _meshers(cfg, tree)
    assert jm._lod_two_pass and tm._lod_two_pass
    axes, pts = _jax_grid(jm)
    for coarse in (True, False):
        _close(tm.eval_points(GridPoints(axes, "cpu"), tp, sdf_only=True,
                              coarse=coarse),
               jm.eval_points(pts, tree, sdf_only=True, coarse=coarse))
    # the whole two-pass grid: capture the SDF each mesher hands to marching
    seen = {}

    def grab(name, real):
        def f(grid, level):
            seen[name] = np.array(grid)
            return real(grid, level)
        return f
    monkeypatch.setattr(jnative, "marching_tetrahedra",
                        grab("jax", jnative.marching_tetrahedra))
    monkeypatch.setattr(native, "marching_tetrahedra",
                        grab("port", native.marching_tetrahedra))
    jm.get_mesh(os.devnull, tree, color=False)
    tm.get_mesh(os.devnull, tp, color=False)
    _close(seen["port"], seen["jax"])
    assert 0 < tm.stats["fine_points"] < tm.stats["grid_points"]


@pytest.mark.parametrize("setup", ["hash", "brick"])
def test_mesh_vertices_faces_colors_match_jax(tmp_path, setup):
    cfg, tree = (_hash_setup(0.05) if setup == "hash"
                 else _brick_setup(0.05))
    jm, tm, tp = _meshers(cfg, tree)
    a, b = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    assert jm.get_mesh(a, tree) == a
    assert tm.get_mesh(b, tp) == b
    (jv, jf, jc), (tv, tf, tc) = jmesh_io.read_ply(a), mesh_io.read_ply(b)
    assert len(tf) > 100
    np.testing.assert_array_equal(tf, jf)
    _close(tv, jv, rtol=0, atol=2e-3 * tm.resolution)
    assert np.abs(tc.astype(int) - jc.astype(int)).max() <= 1
    assert tm.stats["faces"] == len(tf)
    assert tm.stats["marching_vertices"] >= len(tv)


def _banks(n_kf=3, seed=0):
    """A JAX keyframe bank with keyframes of an orbit, and its port copy."""
    rng = np.random.default_rng(seed)
    bank = jkf.init_bank(5, 400)
    add = jkf.make_add_keyframe(20, 20, 400)
    for k in range(n_kf):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.1 * k, 0.05 * k, 0.3]
        dirs = rng.normal(size=(20, 20, 3)).astype(np.float32)
        dirs[..., 2] = -np.abs(dirs[..., 2]) - 0.5
        depth = rng.uniform(0.2, 0.8, (20, 20)).astype(np.float32)
        depth[0, :5] = 0.0
        bank = add(bank, depth, rng.random((20, 20, 3)).astype(np.float32),
                   dirs, c2w, c2w, k, jax.random.PRNGKey(k))
    return bank, tkf.bank_from_jax(
        jax.tree_util.tree_map(np.asarray, bank), device="cpu")


def test_scene_bound_from_bank_matches_jax():
    cfg, tree = _hash_setup(0.08)
    jm, tm, _ = _meshers(cfg, tree)
    jbank, tbank = _banks()
    jb = jm.scene_bound_from_bank(jbank, subsample=7)
    tb = tm.scene_bound_from_bank(tbank, subsample=7)
    pts = np.random.default_rng(3).uniform(-1, 1, (2000, 3))
    inside = tb.contains(pts)
    np.testing.assert_array_equal(inside, jb.contains(pts))
    assert 0 < inside.sum() < len(pts)
    _, empty = _banks(n_kf=0)
    assert tm.scene_bound_from_bank(empty) is None


@pytest.mark.parametrize("eval_rec", [False, True])
def test_cull_mesh_matches_jax(tmp_path, eval_rec):
    grid = np.random.default_rng(4).normal(size=(14, 15, 16)).astype(
        np.float32)
    verts, faces = native.marching_tetrahedra(grid, 0.0)
    verts = verts / 8.0 - 0.9
    colors = np.random.default_rng(5).random((len(verts), 3))
    frames, poses = [], []
    for k in range(3):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.2 * k, 0.0, 2.0]
        depth = np.full((20, 24), 2.0, np.float32)
        frames.append((np.zeros((20, 24, 3), np.float32), depth, c2w))
        poses.append(c2w)
    intr = JIntrinsics(20, 24, 20.0, 20.0, 11.5, 9.5)
    cfg = {"model": {"truncation": 0.3}}
    outs = []
    for name, fn in (("jax", jcull), ("port", tcull)):
        path = str(tmp_path / f"{name}.ply")
        mesh_io.write_ply(path, verts, faces, colors)
        outs.append(fn(path, cfg, intr, frames=frames,
                       estimate_c2w_list=np.stack(poses),
                       eval_rec=eval_rec))
    assert [os.path.basename(o) for o in outs] == ["jax_culled.ply",
                                                   "port_culled.ply"]
    (jv, jf, jc), (tv, tf, tc) = (mesh_io.read_ply(o) for o in outs)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tc, jc)
    assert 0 < len(tf) < len(faces)


def test_mesher_batches_run_without_grad():
    """Meshing keeps no autograd graph, even when the parameters require
    gradients (a map mid-optimisation)."""
    cfg, tree = _hash_setup(0.1)
    _, tm, tp = _meshers(cfg, tree)
    for v in (tp["sdf_table"], tp["color_table"]):
        v.requires_grad_(True)
    seen = []
    real = tm._query

    def spy(*a):
        out = real(*a)
        seen.append(out.requires_grad)
        return out
    tm._query = spy
    tm.eval_points(np.zeros((10, 3)), tp)
    assert seen == [False] and torch.is_grad_enabled()
