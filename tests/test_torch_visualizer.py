"""The port's visualizer command line, `python -m
unislam_tpu_torch.visualizer`, as a subprocess on a tiny run directory (a
checkpoint of the port and a tetrahedron mesh), on a Python path where
matplotlib and imageio cannot be imported: playback every N-th frame,
playback with mesh snapshots, `--live`, and `--mp4`. Playback prints the
lines and writes the files that the top-level `visualizer.py` (the JAX
package's) does on the same directory.
"""

import os
import shutil
import subprocess
import sys

import cv2
import numpy as np

from test_torch_webviewer import TET_F, TET_V, port_run
from unislam_tpu_torch.utils import mesh_io, playback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "Replica", "room0.yaml")


def _run(args, tmp_path, module=True):
    """The port's CLI (or the top-level script) with `args`; matplotlib and
    imageio are shadowed by modules that refuse to import."""
    block = tmp_path / "no_plotting"
    if not block.exists():
        for name in ("matplotlib", "imageio"):
            (block / name).mkdir(parents=True)
            (block / name / "__init__.py").write_text(
                f"raise ImportError('{name} is not installed')\n")
    path = [str(block), REPO] if module else [REPO]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
    cmd = [sys.executable, "-m", "unislam_tpu_torch.visualizer"] if module \
        else [sys.executable, os.path.join(REPO, "visualizer.py")]
    proc = subprocess.run([*cmd, CFG, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


def test_playback_every_n_and_incremental(tmp_path):
    out = str(tmp_path / "run")
    port_run(out, n_frames=7)
    out_lines = _run(["--output", out, "--every", "3"], tmp_path)
    pngs = sorted(os.listdir(os.path.join(out, "playback")))
    assert pngs == ["00000.png", "00003.png", "00006.png"]
    for p in pngs:
        img = cv2.imread(os.path.join(out, "playback", p))
        assert img.shape == (480, 640, 3)
    mesh = os.path.join(out, "mesh", "final_mesh.ply")
    assert out_lines == [
        f"playback: 7 frames, mesh {mesh} (4 verts)",
        f"wrote 3 playback frames to {os.path.join(out, 'playback')}"]

    # the top-level visualizer.py on a copy: the same lines and files
    ref = str(tmp_path / "ref")
    shutil.copytree(out, ref, ignore=shutil.ignore_patterns("playback"))
    ref_lines = _run(["--output", ref, "--every", "3"], tmp_path,
                     module=False)
    assert [ln.replace(ref, out) for ln in ref_lines] == out_lines
    assert sorted(os.listdir(os.path.join(ref, "playback"))) == pngs

    # a snapshot at frame 2: frames 0 (before it) take the newest mesh,
    # 3 and 6 the snapshot's
    mesh_io.write_ply(os.path.join(out, "mesh", "00002_mesh.ply"),
                      TET_V * 2.0, TET_F)
    shutil.rmtree(os.path.join(out, "playback"))
    inc_lines = _run(["--output", out, "--every", "3", "--incremental"],
                     tmp_path)
    assert inc_lines[0].endswith("[incremental snapshots]")
    assert sorted(os.listdir(os.path.join(out, "playback"))) == pngs


def test_live_and_mp4(tmp_path):
    out = str(tmp_path / "run")
    _, slam = port_run(out, n_frames=7)
    playback.write_live_state(out, 6, 7, slam.est_c2w, slam.gt_c2w)
    lines = _run(["--output", out, "--live", "--poll", "0.05"], tmp_path)
    png = os.path.join(out, "live_view", "00006.png")
    assert lines == [
        f"[live] frame 6/7 mesh=final_mesh.ply -> {png}",
        f"live view ended: 1 frames under {out}/live_view"]
    assert cv2.imread(png).shape == (480, 640, 3)

    lines = _run(["--output", out, "--every", "2", "--mp4"], tmp_path)
    assert len(os.listdir(os.path.join(out, "playback"))) in (4, 5)
    mp4 = os.path.join(out, "playback", "playback.mp4")
    if lines[-1] == f"wrote {os.path.join(out, 'playback')}/playback.mp4":
        cap = cv2.VideoCapture(mp4)
        try:
            assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 4
        finally:
            cap.release()
    else:       # the host's cv2 has no mp4 encoder: the PNGs stay
        assert lines[-1].startswith("mp4 export unavailable (")
        assert lines[-1].endswith("); PNG frames kept")


def test_no_checkpoint_or_mesh_says_so(tmp_path):
    out = str(tmp_path / "run")
    assert _run(["--output", out], tmp_path) == [
        f"no checkpoint under {out}/ckpts"]
    port_run(out, n_frames=3)
    os.remove(os.path.join(out, "mesh", "final_mesh.ply"))
    assert _run(["--output", out], tmp_path) == [
        f"no meshes under {os.path.join(out, 'mesh')}"]
    assert np.load(os.path.join(out, "ckpts", "00002.npz"))["est_c2w"] \
        .shape == (3, 4, 4)


def test_web_serves_the_run(tmp_path):
    import socket
    import time
    import urllib.request

    out = str(tmp_path / "run")
    port_run(out, n_frames=3)
    with socket.socket() as s:          # a free port for the server
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "unislam_tpu_torch.visualizer", CFG,
         "--output", out, "--web", "--port", str(port)], cwd=REPO,
        env=dict(os.environ, PYTHONUNBUFFERED="1"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline, state = time.monotonic() + 120, None
        while state is None and time.monotonic() < deadline:
            assert proc.poll() is None, proc.stderr.read()[-3000:]
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/state", timeout=5) as r:
                    state = r.read()
            except OSError:
                time.sleep(0.2)
        assert state is not None
        assert b'"frame": 2' in state and b'"mesh": "final_mesh.ply"' in state
    finally:
        proc.terminate()
        stdout, _ = proc.communicate(timeout=30)
    assert stdout.startswith(f"viewer: http://127.0.0.1:{port}  (output={out})")


def test_smoke_viewer_phase_on_a_cpu_cli_run(tmp_path):
    """`chip_smoke.viewer_phase`, the smoke's viewer checks, on the run
    directory of the port's CLI on the CPU (the tiny Replica of
    tests/test_torch_cli.py, 7 frames: run to frame 5, then `--resume`,
    only final meshes as at the smoke's mesh_freq)."""
    import yaml

    import chip_smoke
    from test_torch_runtime import _room_cfg, _write_room

    folder = str(tmp_path)
    ds = _write_room(folder)
    cfg = _room_cfg(folder, ds)
    cfg["mapping"]["mesh_freq"] = 100000
    cfg_path = os.path.join(folder, "room.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for extra in (["--n_frames", "5"], ["--resume"]):
        proc = subprocess.run(
            [sys.executable, "-m", "unislam_tpu_torch.run", cfg_path,
             "--device", "cpu", *extra], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
    out = cfg["data"]["output"]
    rec = chip_smoke.viewer_phase(cfg_path, out, 7, str(tmp_path / "smoke"),
                                  "no card")
    assert [rec[m]["pngs"] for m in ("playback", "incremental", "mp4",
                                     "live")] == [1, 1, 1, 1]
    newest = playback.newest_mesh(os.path.join(out, "mesh"))
    assert rec["web"]["state_mesh"] == os.path.basename(newest)
    assert rec["web"]["mesh_equal"] and rec["web"]["traversal"] == 404
    assert os.path.exists(tmp_path / "smoke" / "cli" / "viewer.log")
