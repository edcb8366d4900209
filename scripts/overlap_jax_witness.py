#!/usr/bin/env python3
"""Tracking error of the JAX package's overlapped driver with a
ray-sharded mapping side, on the small synthetic room of the overlap
tests.

    python3 scripts/overlap_jax_witness.py [--seeds 0,1,2,3] [--jobs N]

The reference witness for `tests/test_torch_overlap_ranks.py`, which runs
it with `--jobs 4` beside the port's ranks and takes its median: the JAX
package's `OverlappedSLAM` (`unislam_tpu/engine/overlap.py`) on 8 virtual
CPU devices, as the tests' conftest sets them up, so tracking runs on one
and mapping on a ray-sharded sub-mesh of the other 7; the scene and the
config are `tests/test_overlap.py`'s `_small` at 7 frames (40x52, tracking
600 rays x 16 iterations, mapping 800 rays x 8, every second frame). One
process a seed, `--jobs` of them at once.

It imports nothing of the PyTorch port. The two packages draw their rays
from different generators, and the overlapped drivers adopt a snapshot
when its copy has finished, so a seed here and the same seed in the port
are different runs. Prints one JSON line per seed (ATE-RMSE in cm,
mapping phases, keyframes, wall s) and a `summary` line with the median
ATE. About 45 s a seed on 4 CPU cores; the four seeds at once take about
70 s on 8.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 7


def one_seed(seed: int) -> dict:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_overlap import _small
    from unislam_tpu.engine.overlap import OverlappedSLAM
    from unislam_tpu.tools.eval_ate import evaluate_ate

    t0 = time.perf_counter()
    ds, cfg = _small(n_frames=N_FRAMES)
    slam = OverlappedSLAM(cfg, ds, seed=seed)
    est = slam.run(progress=False)
    _, ate = evaluate_ate(slam.gt_c2w[:, :3, 3], est[:, :3, 3])
    return {"seed": seed, "frames": N_FRAMES, "devices": len(jax.devices()),
            "map_devices": int(slam.map_mesh.devices.size),
            "ate_cm": ate["error.rmse"], "mapping_cnt": slam.mapping_cnt,
            "kf_count": int(slam.bank.count),
            "wall_s": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--jobs", type=int, default=1,
                    help="seeds run at once")
    ap.add_argument("--one", type=int, default=None,
                    help=argparse.SUPPRESS)   # a child's seed
    args = ap.parse_args()
    if args.one is not None:
        print("RESULT " + json.dumps(one_seed(args.one)), flush=True)
        return 0
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    for i in range(0, len(seeds), args.jobs):
        # a fresh process a seed (the device count is fixed at import),
        # `--jobs` at a time
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--one", str(seed)], cwd=HERE,
                                  stdout=subprocess.PIPE, text=True)
                 for seed in seeds[i:i + args.jobs]]
        for p in procs:
            out = p.communicate()[0]
            if p.returncode != 0:
                raise RuntimeError(f"a seed's process exited {p.returncode}")
            line = next(x for x in out.splitlines()
                        if x.startswith("RESULT "))
            runs.append(json.loads(line[len("RESULT "):]))
            print(json.dumps(runs[-1]), flush=True)
    ates = [r["ate_cm"] for r in runs]
    print("summary " + json.dumps({"ate_cm": ates,
                                   "median_cm": statistics.median(ates)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
