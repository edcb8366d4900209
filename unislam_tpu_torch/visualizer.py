"""SLAM map observability of a port run: offline playback, live follower,
web viewer. The port's counterpart of the top-level `visualizer.py`:

    python -m unislam_tpu_torch.visualizer configs/Replica/room0.yaml
        [--output DIR] [--every 10] [--mp4]
        [--incremental | --live [--poll 2.0]
         | --web [--port 8090] [--host 127.0.0.1]]

It renders third-person views (native z-buffer rasterizer, drawn with
cv2: no GL, no matplotlib) in three modes:

  playback     (default) post-hoc turntable over the run's trajectory with
               the final mesh, every N-th frame into `<output>/playback/`.
  --incremental  playback where each frame shows the mesh snapshot that
               existed at that point of the run (map evolution; falls back
               to the newest mesh before the first `mapping.mesh_freq`
               snapshot).
  --live       follow a RUNNING run: poll `<output>/live.json` (written by
               the runtime every `live_freq`-th frame) and render the
               newest mesh + trajectory as they grow, into
               `<output>/live_view/`.
  --web        serve the interactive WebGL viewer over HTTP (orbit camera,
               live mesh + trajectory + camera-frustum actors, snapshot
               scrubber), usable from any browser via an SSH port-forward.
               See utils/webviewer.py.

`--mp4` also writes the PNGs as `playback.mp4` (10 fps) with cv2's
VideoWriter; where the host's cv2 has no mp4 encoder the PNGs are kept and
a line says so. Host code only: nothing here touches a tensor or device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

PACKAGE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(PACKAGE)


def main(argv=None):
    parser = argparse.ArgumentParser(description="SLAM playback / live view.")
    parser.add_argument("config", type=str)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--every", type=int, default=10,
                        help="render every N-th frame")
    parser.add_argument("--mp4", action="store_true")
    parser.add_argument("--incremental", action="store_true",
                        help="playback with per-frame mesh snapshots")
    parser.add_argument("--live", action="store_true",
                        help="follow a running run via live.json")
    parser.add_argument("--poll", type=float, default=2.0,
                        help="--live poll interval (s)")
    parser.add_argument("--web", action="store_true",
                        help="serve the interactive WebGL viewer over HTTP")
    parser.add_argument("--port", type=int, default=8090)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    args = parser.parse_args(argv)

    from unislam_tpu_torch.config import load_config
    from unislam_tpu_torch.utils import playback
    from unislam_tpu_torch.utils.logger import (latest_checkpoint,
                                                load_checkpoint)
    from unislam_tpu_torch.utils.mesh_io import read_ply

    cfg = load_config(args.config,
                      os.path.join(REPO, "configs", "UNISLAM.yaml"))
    output = args.output or cfg["data"]["output"]
    mesh_dir = os.path.join(output, "mesh")

    if args.web:
        from unislam_tpu_torch.utils import webviewer
        webviewer.serve(output, port=args.port, host=args.host)
        return

    if args.live:
        pngs = playback.follow_live(output, poll_s=args.poll)
        print(f"live view ended: {len(pngs)} frames under "
              f"{output}/live_view")
        _maybe_mp4(args, os.path.join(output, "live_view"), pngs)
        return

    ckpt_path = latest_checkpoint(os.path.join(output, "ckpts"))
    if ckpt_path is None:
        print(f"no checkpoint under {output}/ckpts")
        return
    ckpt = load_checkpoint(ckpt_path)
    est = ckpt["est_c2w"]
    gt = ckpt["gt_c2w"]

    final_mesh = playback.newest_mesh(mesh_dir)
    if final_mesh is None:
        print(f"no meshes under {mesh_dir}")
        return
    verts, faces, _ = read_ply(final_mesh)
    print(f"playback: {len(est)} frames, mesh {final_mesh} "
          f"({len(verts)} verts)"
          + (" [incremental snapshots]" if args.incremental else ""))

    vis_dir = os.path.join(output, "playback")
    os.makedirs(vis_dir, exist_ok=True)
    frames_out = []
    n = len(est)
    cur_mesh = final_mesh
    for k, i in enumerate(range(0, n, args.every)):
        if args.incremental:
            snap = playback.mesh_snapshot_for_frame(mesh_dir, i)
            if snap and snap != cur_mesh:
                verts, faces, _ = read_ply(snap)
                cur_mesh = snap
        th = 2 * np.pi * k / max(1, (n // args.every)) * 0.25 + 0.6
        out_png = os.path.join(vis_dir, f"{i:05d}.png")
        playback.render_view(out_png, verts, faces, est[:i + 1, :3, 3],
                             gt[:i + 1, :3, 3], est[i], i, n, theta=th)
        frames_out.append(out_png)

    print(f"wrote {len(frames_out)} playback frames to {vis_dir}")
    _maybe_mp4(args, vis_dir, frames_out)


def _maybe_mp4(args, vis_dir, frames_out):
    """With --mp4, the PNGs (all of one size) as `<vis_dir>/playback.mp4`
    at 10 fps (cv2 VideoWriter, FourCC mp4v); where the writer will not
    open or a frame will not read, the PNGs are kept and a line says
    why."""
    if not (args.mp4 and frames_out):
        return
    import cv2

    path = os.path.join(vis_dir, "playback.mp4")
    writer = None
    try:
        first = cv2.imread(frames_out[0])
        if first is None:
            raise OSError(f"cannot read {frames_out[0]}")
        h, w = first.shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 10.0, (w, h))
        if not writer.isOpened():
            raise OSError("cv2.VideoWriter with FourCC mp4v did not open")
        for p in frames_out:
            img = cv2.imread(p)
            if img is None:
                raise OSError(f"cannot read {p}")
            writer.write(img)
        writer.release()
        writer = None
        print(f"wrote {vis_dir}/playback.mp4")
    except (OSError, cv2.error) as e:
        print(f"mp4 export unavailable ({e}); PNG frames kept")
    finally:
        if writer is not None:
            writer.release()


if __name__ == "__main__":
    main()
