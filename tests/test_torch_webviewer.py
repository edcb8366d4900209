"""Port parity for the HTTP live viewer (`unislam_tpu_torch/utils/
webviewer.py`): the port's server and the JAX package's server, started on
one run directory, answer every route alike (status, content type,
`Cache-Control`, body); the page differs only in its title. The post-hoc
state is read from a checkpoint the port's `save_checkpoint` wrote.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_runtime import _port_slam
from unislam_tpu.utils import webviewer as jwebviewer
from unislam_tpu_torch.utils import logger, mesh_io, playback, webviewer

TET_V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
TET_F = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)

PATHS = ["/", "/index.html", "/state", "/state?t=1", "/mesh/mesh_000010.ply",
         "/mesh/mesh_000020.ply", "/mesh/", "/mesh/../secret.ply",
         "/mesh/%2e%2e/secret.ply", "/mesh/..%2Fsecret.ply",
         "/mesh/missing.ply", "/mesh/live.json", "/nowhere", "/index.htm"]


def port_run(out, n_frames=7, idx=None, seed=3):
    """A run directory as the port's runtime leaves it: a checkpoint of a
    port UniSLAM at frame `idx` (default the last) with poses around a
    tetrahedron, and the tetrahedron as the final mesh."""
    idx = n_frames - 1 if idx is None else idx
    slam = _port_slam(n_frames)
    rs = np.random.default_rng(seed)
    for poses in (slam.est_c2w, slam.gt_c2w):
        poses[:] = np.eye(4, dtype=np.float32)
        poses[:, :3, 3] = 0.3 + 0.2 * rs.random((n_frames, 3))
    os.makedirs(os.path.join(out, "mesh"), exist_ok=True)
    mesh_io.write_ply(os.path.join(out, "mesh", "final_mesh.ply"),
                      TET_V, TET_F)
    return logger.save_checkpoint(
        os.path.join(out, "ckpts", f"{idx:05d}.npz"), slam, idx), slam


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return (r.status, r.headers.get("Content-Type"),
                    r.headers.get("Cache-Control"), r.read())
    except urllib.error.HTTPError as e:
        return (e.code, e.headers.get("Content-Type"),
                e.headers.get("Cache-Control"), e.read())


def _servers(run_dir):
    srvs = [mod.start_background(run_dir, port=0)
            for mod in (webviewer, jwebviewer)]
    return srvs, [f"http://127.0.0.1:{s.server_address[1]}" for s in srvs]


def _stop(srvs):
    for s in srvs:
        s.shutdown()
        s.server_close()


def _untitled(body: bytes) -> bytes:
    return body.replace(b"<title>unislam_tpu_torch live viewer</title>",
                        b"<title></title>").replace(
        b"<title>unislam_tpu live viewer</title>", b"<title></title>")


def _compare(run_dir):
    srvs, (ours, ref) = _servers(run_dir)
    try:
        got = {p: _get(ours + p) for p in PATHS}
        want = {p: _get(ref + p) for p in PATHS}
    finally:
        _stop(srvs)
    for p in PATHS:
        a, b = got[p], want[p]
        assert a[:3] == b[:3], p
        if p in ("/", "/index.html"):
            assert a[3] != b[3] and _untitled(a[3]) == _untitled(b[3])
            assert b"<title>unislam_tpu_torch live viewer</title>" in a[3]
        else:
            assert a[3] == b[3], p
    return got


@pytest.fixture()
def live_run(tmp_path):
    """test_webviewer.py's run: live.json + two mesh snapshots, and a
    secret outside mesh/."""
    out = tmp_path / "run"
    mesh_dir = out / "mesh"
    mesh_dir.mkdir(parents=True)
    colors = np.full((4, 3), 0.5, np.float32)
    mesh_io.write_ply(str(mesh_dir / "mesh_000010.ply"), TET_V, TET_F[:2],
                      colors)
    mesh_io.write_ply(str(mesh_dir / "mesh_000020.ply"), TET_V + 1.0,
                      TET_F[:2], colors)
    (out / "secret.ply").write_text("nope")
    est = np.tile(np.eye(4, dtype=np.float32), (21, 1, 1))
    est[:, 0, 3] = np.linspace(0, 2, 21)
    playback.write_live_state(str(out), 20, 40, est, est,
                              mesh_dir=str(mesh_dir))
    return str(out)


def test_live_run_answers_as_jax(live_run):
    got = _compare(live_run)
    assert got["/"][:3] == (200, "text/html; charset=utf-8", "no-store")
    status, ctype, _, body = got["/state"]
    state = json.loads(body)
    assert (status, ctype) == (200, "application/json")
    assert state["frame"] == 20 and state["mesh"] == "mesh_000020.ply"
    assert state["meshes"] == ["mesh_000010.ply", "mesh_000020.ply"]
    with open(os.path.join(live_run, "mesh", "mesh_000010.ply"), "rb") as f:
        assert got["/mesh/mesh_000010.ply"][3] == f.read()
    for p in ("/mesh/../secret.ply", "/mesh/%2e%2e/secret.ply",
              "/mesh/..%2Fsecret.ply", "/mesh/live.json", "/nowhere"):
        assert got[p][0] == 404 and got[p][3] == b"not found", p


def test_finished_run_answers_from_the_port_checkpoint(tmp_path):
    out = str(tmp_path / "done")
    ckpt, slam = port_run(out, n_frames=7, idx=4)
    got = _compare(out)
    state = json.loads(got["/state"][3])
    assert state["done"] and state["frame"] == 4 and state["n_img"] == 7
    assert state["mesh"] == "final_mesh.ply"
    # the values come from the archive's arrays
    assert state == {**webviewer._posthoc_state(out),
                     "mesh": "final_mesh.ply", "meshes": ["final_mesh.ply"]}
    np.testing.assert_array_equal(
        state["est_t"], np.asarray(slam.est_c2w[:5, :3, 3],
                                   np.float64).round(5))
    np.testing.assert_array_equal(
        state["cur_c2w"], np.asarray(slam.est_c2w[4], np.float64))
    ours = webviewer._posthoc_state(out)
    assert ours == jwebviewer._posthoc_state(out)
    assert ours["mesh"] == os.path.join(out, "mesh", "final_mesh.ply")
    assert os.path.basename(ckpt) == "00004.npz"


def test_empty_run_has_no_state(tmp_path):
    out = str(tmp_path / "empty")
    os.makedirs(out)
    assert webviewer._posthoc_state(out) is None
    srvs, (ours, ref) = _servers(out)
    try:
        a, b = _get(ours + "/state"), _get(ref + "/state")
    finally:
        _stop(srvs)
    assert a == b and a[0] == 404
    assert a[3] == b'{"error": "no run data yet"}'
