"""The port's evaluation surface against the JAX package's: `render_img`
(both encodings, with and without sensor depth, on the JAX run's own
per-chunk draws), `pose_evaluation`'s results and files, the
reconstruction metrics of `eval_recon`, `eval_rendering` on a tiny map,
the frame visualiser, and the branch where matplotlib is missing (every
number still written, only the figure files skipped).

Tolerances as in `tests/test_torch_scene_render.py`: values rtol 1e-5 /
atol 1e-6, renders rtol 1e-4 / atol 1e-5; rendered 8-bit images within 1.
"""

import builtins
import json
import os
import types

import cv2
import jax
import numpy as np
import pytest
import torch

from test_torch_engine import INTR, World
from test_torch_lod import BrickWorld
from unislam_tpu.render import renderer as jrender
from unislam_tpu.tools import eval_ate as jate
from unislam_tpu.tools import eval_recon as jrecon
from unislam_tpu.utils import mesh_io as jmesh_io
from unislam_tpu_torch.models import scene as tscene
from unislam_tpu_torch.render import renderer as trender
from unislam_tpu_torch.tools import eval_ate as tate
from unislam_tpu_torch.tools import eval_recon as trecon
from unislam_tpu_torch.utils import plots
from unislam_tpu_torch.utils.visualizer import FrameVisualizer

CHUNK = 160        # 24 x 32 = 768 rays: 5 chunks, the last one padded


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _chunk_draws(key, n_chunks, R, ns, ni):
    """The draws JAX's render_img takes, chunk by chunk."""
    draws = []
    for _ in range(n_chunks):
        key, sub = jax.random.split(key)
        k_surf, k_uni, k_pdf = jax.random.split(sub, 3)
        draws.append({k: torch.tensor(np.asarray(v)) for k, v in {
            "t_depth": jax.random.uniform(k_surf, (R, ns + ni)),
            "t_uni": jax.random.uniform(k_uni, (R, ns)),
            "u_pdf": jax.random.uniform(k_pdf, (R, ni))}.items()})
    return draws


@pytest.mark.parametrize("encoding", ["hash", "brick"])
@pytest.mark.parametrize("depth", ["sensor", "holes", "none"])
def test_render_img_matches_jax(encoding, depth):
    w = World(seed=1) if encoding == "hash" else BrickWorld(seed=1)
    jrc = w.jrc._replace(ray_batch_size=CHUNK)
    trc = w.trc._replace(ray_batch_size=CHUNK)
    _, gt_depth, c2w = w.frame(2)
    if depth == "holes":
        gt_depth = gt_depth.copy()
        gt_depth[3:7, 5:20] = 0.0
    gd = None if depth == "none" else gt_depth
    key = jax.random.PRNGKey(11)
    ref = jrender.render_img(w.tree, w.jsc, jrc, w.jintr, c2w, key,
                             gt_depth=gd)
    n_chunks = -(-INTR["H"] * INTR["W"] // CHUNK)
    draws = _chunk_draws(key, n_chunks, CHUNK, trc.n_stratified,
                         trc.n_importance)
    params = tscene.params_from_jax(w.tree, device="cpu")
    out = trender.render_img(params, w.tsc, trc, w.tintr, c2w, gt_depth=gd,
                             draws=draws)
    assert [tuple(o.shape) for o in out] == [tuple(np.shape(r))
                                             for r in ref]
    for a, b in zip(out, ref):
        _close(a, b, rtol=1e-4, atol=1e-5)


def test_render_img_keeps_no_graph_and_counts_chunks(monkeypatch):
    """render_img runs under no_grad (params that require gradients give
    outputs without a graph) and calls the renderer once per chunk, with
    the probe only in chunks holding a pixel without depth."""
    w = World(seed=2)
    params = tscene.params_from_jax(w.tree, device="cpu")
    for v in (params["sdf_table"], params["color_table"]):
        v.requires_grad_(True)
    calls = []
    real = trender.render_rays

    def spy(*a, probe=None, **k):
        calls.append(probe)
        return real(*a, probe=probe, **k)
    monkeypatch.setattr(trender, "render_rays", spy)
    _, gt_depth, c2w = w.frame(1)
    gt_depth = gt_depth.copy()
    gt_depth[0, :3] = 0.0                       # chunk 0 only
    out = trender.render_img(params, w.tsc,
                             w.trc._replace(ray_batch_size=CHUNK), w.tintr,
                             c2w, torch.Generator().manual_seed(0),
                             gt_depth=gt_depth)
    assert calls == [True, False, False, False, False]
    assert not any(o.requires_grad for o in out)


# ---------------------------------------------------------------- ATE

def test_pose_evaluation_results_and_files_match_jax(tmp_path):
    rs = np.random.default_rng(0)
    n = 12
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, 3] = np.cumsum(rs.normal(size=(n, 3)) * 0.05, axis=0)
    est = gt.copy()
    est[:, :3, 3] += rs.normal(size=(n, 3)) * 0.01
    gt[4] = np.nan                                  # skipped frame
    w = rs.random(n)
    for align in (False, True):
        outs = []
        for mod, name in ((jate, "jax"), (tate, "port")):
            plot = str(tmp_path / name / "pose_11.png")
            outs.append(mod.pose_evaluation(gt, est, w, plot, scale=2.0,
                                            pose_alignment=align))
            with open(tmp_path / name / "trans_error_data.json") as f:
                outs[-1] += (json.load(f),)
            for fig in ("pose_11.png", "velocity.png",
                        "translation_error_scatter.png"):
                assert os.path.exists(tmp_path / name / fig)
        (je, jr, jj), (te, tr, tj) = outs
        assert tr == jr and tj == jj
        _close(te, je)
    for mod, name in ((jate, "jax"), (tate, "port")):
        mod.vis_unc_mapstep(w, (w > 0.5).astype(int), str(tmp_path / name))
        assert os.path.exists(tmp_path / name / "uncertainty_record.png")
    q = np.random.default_rng(9).random((6, 4))
    for a, b in zip(tate.angular_velocity_from_quats(q),
                    jate.angular_velocity_from_quats(q)):
        _close(a, b)
    x = np.r_[np.ones(10), 500.0, -500.0]
    _close(tate.replace_outliers_with_median(x),
           jate.replace_outliers_with_median(x))


# ---------------------------------------------------------------- recon

def _sphere_ply(path, r, shift=0.0, n=24):
    from unislam_tpu_torch.utils import native
    x = np.linspace(-1, 1, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    v, f = native.marching_tetrahedra(np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - r,
                                      0.0)
    jmesh_io.write_ply(path, v / (n - 1) * 2 - 1 + shift, f)
    return path


def test_recon_metrics_match_jax(tmp_path):
    rec = _sphere_ply(str(tmp_path / "rec.ply"), 0.6, shift=0.01)
    gt = _sphere_ply(str(tmp_path / "gt.ply"), 0.62)
    v, f, _ = jmesh_io.read_ply(gt)
    np.testing.assert_array_equal(trecon.sample_surface(v, f, 500, seed=3),
                                  jrecon.sample_surface(v, f, 500, seed=3))
    src = trecon.sample_surface(v, f, 400, seed=1)
    np.testing.assert_array_equal(trecon.icp_align(src + 0.02, src),
                                  jrecon.icp_align(src + 0.02, src))
    for align in (False, True):
        assert trecon.calc_3d_metric(rec, gt, align=align, num_points=3000) \
            == jrecon.calc_3d_metric(rec, gt, align=align, num_points=3000)
    assert trecon.calc_2d_metric(rec, gt, n_imgs=3) == \
        jrecon.calc_2d_metric(rec, gt, n_imgs=3)
    a = np.random.default_rng(4).random((40, 56, 3))
    b = np.clip(a + np.random.default_rng(5).normal(0, 0.05, a.shape), 0, 1)
    assert trecon.ms_ssim(a, b) == jrecon.ms_ssim(a, b)
    assert trecon.lpips_weights_path() == jrecon.lpips_weights_path()


def _tiny_slams(tmp_path, encoding):
    """The same tiny map and trajectory as the JAX and the port's
    eval_rendering read them."""
    w = World(seed=3) if encoding == "hash" else BrickWorld(seed=3)
    frames = [w.frame(i) for i in range(6)]
    est = np.stack([f[2] for f in frames]).astype(np.float32)
    est[:, :3, 3] += 0.002
    jslam = types.SimpleNamespace(
        params=w.tree, sc=w.jsc, rc=w.jrc._replace(ray_batch_size=CHUNK),
        intr=w.jintr, est_c2w=est, n_img=6, dataset=frames)
    tslam = types.SimpleNamespace(
        params=tscene.params_from_jax(w.tree, device="cpu"), sc=w.tsc,
        rc=w.trc._replace(ray_batch_size=CHUNK), intr=w.tintr, est_c2w=est,
        n_img=6, dataset=frames, device=torch.device("cpu"))
    return jslam, tslam


@pytest.mark.parametrize("encoding", ["hash", "brick"])
def test_eval_rendering_matches_jax(tmp_path, encoding):
    jslam, tslam = _tiny_slams(tmp_path, encoding)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jres = jrecon.eval_rendering(jslam, jout, every=2)
    timings = {}
    tres = trecon.eval_rendering(tslam, tout, every=2, timings=timings)
    assert tres.keys() == jres.keys()
    for k in ("avg_psnr", "avg_ms_ssim", "depth_l1_render"):
        _close(tres[k], jres[k], rtol=1e-4, atol=1e-4)
    assert tres["avg_lpips"] is None and "lpips_note" in tres
    assert timings["images"] == 3 and timings["render_s"] > 0
    for sub in ("rendered_image", "rendered_uncertainty"):
        names = sorted(os.listdir(os.path.join(jout, sub)))
        assert names == sorted(os.listdir(os.path.join(tout, sub)))
        assert len(names) == 3
        for n in names:
            a = cv2.imread(os.path.join(jout, sub, n)).astype(int)
            b = cv2.imread(os.path.join(tout, sub, n)).astype(int)
            assert np.abs(a - b).max() <= 1
    with open(os.path.join(tout, "output.txt")) as f:
        assert json.loads(f.readline()) == json.loads(json.dumps(tres))


# ---------------------------------------------------------------- plots

def _no_matplotlib(monkeypatch):
    real_import = builtins.__import__

    def imp(name, *a, **k):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib")
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", imp)
    monkeypatch.setattr(plots, "_said", False)


def test_without_matplotlib_numbers_are_written_figures_skipped(
        tmp_path, monkeypatch, capsys):
    _, tslam = _tiny_slams(tmp_path, "hash")
    with_mpl = trecon.eval_rendering(tslam, str(tmp_path / "with"), every=3)
    _no_matplotlib(monkeypatch)
    out = str(tmp_path / "without")
    res = trecon.eval_rendering(tslam, out, every=3)
    assert res == with_mpl
    assert len(os.listdir(os.path.join(out, "rendered_image"))) == 2
    assert os.listdir(os.path.join(out, "rendered_uncertainty")) == []
    n = 6
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 0, 3] = np.arange(n) * 0.1
    _, r1 = tate.pose_evaluation(gt, gt + 0.001, np.ones(n),
                                 str(tmp_path / "pv" / "pose_5.png"))
    assert r1["compared_pose_pairs"] == n
    assert os.path.exists(tmp_path / "pv" / "trans_error_data.json")
    assert not os.path.exists(tmp_path / "pv" / "pose_5.png")
    tate.vis_unc_mapstep(np.ones(n), np.zeros(n), str(tmp_path / "pv"))
    assert not os.path.exists(tmp_path / "pv" / "uncertainty_record.png")
    vis = FrameVisualizer(1, str(tmp_path / "vis"), tslam.sc, tslam.rc,
                          tslam.intr)
    color, depth, c2w = tslam.dataset[1]
    assert vis.save_imgs(1, 0, depth, color, c2w, tslam.params) is None
    assert "psnr" in open(tmp_path / "vis" / "psnr_record.txt").read()
    vis.save_mapping_imgs(1, 2, color, c2w, tslam.params, gt_depth=depth)
    assert os.path.exists(tmp_path / "vis" / "render_img_1" / "2.png")
    said = capsys.readouterr().out
    assert said.count("INFO: matplotlib is not installed") == 1


def test_frame_visualizer_panels_match_jax_records(tmp_path):
    """The panel renders the frame like the JAX visualiser: the same PSNR
    record line, and the panel and colour bar files."""
    from unislam_tpu.utils.visualizer import FrameVisualizer as JVis
    jslam, tslam = _tiny_slams(tmp_path, "hash")
    color, depth, c2w = tslam.dataset[2]
    jv = JVis(2, str(tmp_path / "j"), jslam.sc, jslam.rc, jslam.intr)
    tv = FrameVisualizer(2, str(tmp_path / "t"), tslam.sc, tslam.rc,
                         tslam.intr)
    assert jv.save_imgs(2, 3, depth, color, c2w, jslam.params) is not None
    assert tv.save_imgs(2, 3, depth, color, c2w, tslam.params) is not None
    assert tv.save_imgs(3, 0, depth, color, c2w, tslam.params) is None
    rec = [open(tmp_path / d / "psnr_record.txt").read().split()
           for d in ("j", "t")]
    assert rec[0][:4] == rec[1][:4]
    _close(float(rec[1][-1]), float(rec[0][-1]), rtol=1e-4, atol=1e-3)
    for name in ("00002_0003.jpg", "uncertainty_bar.png"):
        assert os.path.exists(tmp_path / "t" / name)
