"""Command line of the PyTorch port:

    python -m unislam_tpu_torch.run configs/Replica/room0.yaml
        [--input_folder DIR] [--output DIR] [--resume] [--n_frames N]
        [--device cuda|cpu]

The arguments of the JAX package's `run.py`, with `--device` in place of
`--platform`: the run is on the CUDA device unless `--device cpu` is given,
and without a GPU it raises rather than fall back to the CPU. It writes the
merged `config.yaml` and a `src_snapshot/` of the `unislam_tpu_torch`
package into the output folder (kept as it is on `--resume`, which
continues from the newest checkpoint), then runs `SLAMRuntime`.

On N ranks (`parallel.data_parallel: true`), start one process a card with
the UNISLAM_* variables set (`parallel/distributed.py`): UNISLAM_COORDINATOR
(host:port of rank 0), UNISLAM_NUM_PROCESSES and UNISLAM_PROCESS_ID. Rank r
runs on cuda:(r % cards on its host); only rank 0 writes.

An overlapped run (`parallel.overlap: true`) on N >= 2 ranks is launched
the same way: rank 0 tracks, ranks 1..N-1 map data-parallel, and rank 1
writes. On one host with N cards:

    for r in $(seq 0 $((N - 1))); do
      UNISLAM_COORDINATOR=localhost:29500 UNISLAM_NUM_PROCESSES=$N \
      UNISLAM_PROCESS_ID=$r python -m unislam_tpu_torch.run <config> &
    done; wait
"""

from __future__ import annotations

import argparse
import os
import shutil

import yaml

PACKAGE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(PACKAGE)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run Uni-SLAM on PyTorch (CUDA by default).")
    parser.add_argument("config", type=str, help="Path to config file.")
    parser.add_argument("--input_folder", type=str, default=None,
                        help="input folder, overrides the config")
    parser.add_argument("--output", type=str, default=None,
                        help="output folder, overrides the config")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint")
    parser.add_argument("--n_frames", type=int, default=None,
                        help="only process the first N frames")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from unislam_tpu_torch import resolve_device
    from unislam_tpu_torch.config import load_config
    from unislam_tpu_torch.parallel import distributed as pdist
    from unislam_tpu_torch.runtime import SLAMRuntime

    device = resolve_device(args.device)
    pdist.initialize_from_env(device=device)
    cfg = load_config(args.config,
                      os.path.join(REPO, "configs", "UNISLAM.yaml"))
    output = args.output or cfg["data"]["output"]
    os.makedirs(output, exist_ok=True)
    runtime = SLAMRuntime(cfg, input_folder=args.input_folder, output=output,
                          n_frames=args.n_frames, device=device)
    # reproducibility: the merged config and a snapshot of the code
    if runtime.writer:
        _write_snapshot(cfg, output, os.path.join(output, "src_snapshot"),
                        args.resume)
    if args.resume:
        runtime.resume()
    runtime.run()


def _write_snapshot(cfg, output: str, snap: str, resume: bool) -> None:
    with open(os.path.join(output, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    if resume and os.path.isdir(snap):
        # the snapshot of the code that produced the earlier frames stays
        print(f"--resume: keeping existing source snapshot {snap}")
    else:
        if os.path.isdir(snap):
            shutil.rmtree(snap)
        shutil.copytree(PACKAGE, os.path.join(snap, "unislam_tpu_torch"),
                        ignore=shutil.ignore_patterns(
                            "__pycache__", "*.pyc", "*.so", "build"))


if __name__ == "__main__":
    main()
