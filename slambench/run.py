#!/usr/bin/env python3
"""The port's benchmark: one RGB-D stream through `UniSLAM.step_frame`.

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1> [--rehearse]

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`:
the frozen, fully merged config, the procedural room and the stream's
declared length) and a traffic mix (`traffic/<name>.json`: the orbit's
speed, the depth dropouts, the warm-up and the profiled stretch). A run:

1. set-up: builds or loads the port's kernels (`build/torch_kernels/` in
   the checkout), renders one closed orbit of frames on the card from the
   seed and hands them to the program as host arrays (frame i is pool
   frame i mod P: every seed gets the same frames in the same order, so
   the work differs between seeds only by what the program's own
   decisions make of it), builds `UniSLAM` (weights and draws from the
   seed) and runs the warm-up frames: frame 0's first mapping phase
   through several steady ones;
2. the window: `step_frame` frame after frame, the next frame going in
   when the last returns (a closed loop of one stream), for `--seconds`,
   with one synchronise at its end;
3. with `--trace 1`, the per-layer metrics: the program's own phase
   times and iteration counts over the window (`profiling.enabled`), and
   torch.profiler over the traffic's stretch of whole mapping cycles;
4. the output check (`check.py`): the next mapping frame from a
   checkpoint the harness draws, against the plain reference.

Metrics are read by `metrics/<name>.py`; the last line of standard output
is the result, the line before it the ATE and the per-frame records
(also written under $TMPDIR). The compared numbers and their limits end
standard error. No card (or fewer than the cell asks for): exit 2, no
result; `--rehearse` runs the same control flow at a tiny size on the CPU
(the port's plain kernel versions) and reports no device metric.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in the measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "unislam_tpu")
# a tiny CPU rehearsal: the cell's config with these sizes
REHEARSAL = {
    "cam": {"H": 34, "W": 60, "fx": 30.0, "fy": 30.0, "cx": 29.5,
            "cy": 16.5, "crop_edge": 0},
    "grid": {"hash_size_sdf": 10, "hash_size_color": 10, "voxel_sdf": 0.2,
             "voxel_color": 0.2},
    "tracking": {"pixels": 48, "iters": 3, "ignore_edge_W": 4,
                 "ignore_edge_H": 4},
    "mapping": {"pixels": 64, "iters": 3, "iters_first": 4},
    "rendering": {"n_stratified": 8, "n_importance": 4},
}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def host_state() -> dict:
    """What the host did for this process so far: the main thread's CPU
    seconds, context switches, the CPU it is on, its allowed CPUs and the
    process's threads (read from its own /proc entries)."""
    import resource
    import threading

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"main_cpu_s": time.thread_time(), "proc_cpu_s": time.process_time(),
           "voluntary_switches": ru.ru_nvcsw,
           "involuntary_switches": ru.ru_nivcsw,
           "affinity": sorted(os.sched_getaffinity(0)),
           "torch_threads": torch.get_num_threads(),
           "py_threads": threading.active_count()}
    try:
        with open("/proc/self/stat") as f:
            out["cpu"] = int(f.read().rsplit(")", 1)[1].split()[36])
        with open("/proc/self/status") as f:
            out["os_threads"] = int(next(ln.split()[1] for ln in f
                                         if ln.startswith("Threads:")))
        # CPU seconds of each thread, summed by thread name
        tick, per = os.sysconf("SC_CLK_TCK"), {}
        for tid in os.listdir("/proc/self/task"):
            with open(f"/proc/self/task/{tid}/stat") as f:
                head, rest = f.read().rsplit(")", 1)
            name = head.split("(", 1)[1]
            utime, stime = rest.split()[11:13]
            per[name] = per.get(name, 0.0) + (int(utime) + int(stime)) / tick
        out["thread_cpu_s"] = per
    except (OSError, ValueError, StopIteration, IndexError):
        pass
    return out


def host_delta(a: dict, b: dict) -> dict:
    """The window's share of `host_state`: counters as differences, the
    rest as read at its start and its end."""
    counters = ("main_cpu_s", "proc_cpu_s", "voluntary_switches",
                "involuntary_switches")
    out = {k: (b[k] - a[k] if k in counters else [a.get(k), b.get(k)])
           for k in b if k != "thread_cpu_s"}
    ta, tb = a.get("thread_cpu_s", {}), b.get("thread_cpu_s", {})
    out["thread_cpu_s"] = {k: v - ta.get(k, 0.0) for k, v in tb.items()}
    return out


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports in this kind of run."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def config_of(spec: dict, rehearse: bool, trace: bool) -> dict:
    from unislam_tpu_torch.config import update_recursive

    cfg = copy.deepcopy(spec["slam"])
    if rehearse:
        cfg["cam"].pop("crop_size", None)
        update_recursive(cfg, REHEARSAL)
    cfg["profiling"] = {"enabled": bool(trace)}
    return cfg


class Session:
    """One run: the program, its stream and frame counter, from set-up to
    the output check. `calibrate.py` and the tests drive the same steps."""

    def __init__(self, workload: str, seed: int, trace: bool = False,
                 rehearse: bool = False):
        from slambench import lib, scene, shapes

        # seconds of each set-up step, for the records
        self.setup = {}
        t = time.perf_counter()
        self.bench = lib.benchmark()
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"unknown workload {workload!r}")
        self.cell = cells[workload]
        self.seed = seed
        self.spec = lib.load_json("configs", self.cell["config"])
        self.traffic = lib.load_json("traffic", self.cell["traffic"])
        self.limits = lib.load_json("limits", workload)
        self.device = torch.device("cpu") if rehearse \
            else torch.device("cuda", 0)
        from unislam_tpu_torch.engine.slam import UniSLAM

        self.cfg = config_of(self.spec, rehearse, trace)
        self.shp = shapes.of(self.cfg)
        t = self._lap("import", t)
        if not rehearse:
            from unislam_tpu_torch.kernels import build
            build.build()
        t = self._lap("kernels", t)
        color, depth, poses = scene.render_pool(
            self.spec["scene"], self.shp["intr"],
            self.traffic["deg_per_frame"], seed,
            self.traffic.get("depth_holes"), self.device)
        self.stream = scene.Stream(color, depth, poses,
                                   self.spec["n_frames"])
        t = self._lap("frame_pool", t)
        self.slam = UniSLAM(self.cfg, self.stream, seed=seed,
                            device=self.device)
        t = self._lap("program", t)
        self.every = self.slam.mc.every_frame
        self.reserve = (self.traffic["profile_phases"] + 2) * self.every + 1
        self.idx = 0
        for _ in range((self.traffic["warmup_phases"] - 1) * self.every + 1):
            self.step()
        self.sync()
        self._lap("warmup", t)

    def _lap(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.setup[name] = t - t0
        return t

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> None:
        if self.idx + self.reserve >= len(self.stream):
            raise RuntimeError(
                f"the run reached frame {self.idx} of the stream's "
                f"{len(self.stream)}: the stream is too short for this rate")
        self.slam.step_frame(self.idx)
        self.idx += 1

    def until(self, residue: int) -> None:
        """Step (untimed) until the next frame index is `residue` modulo
        the mapping cadence."""
        while self.idx % self.every != residue % self.every:
            self.step()

    def window(self, seconds: float) -> dict:
        """`step_frame` frame after frame for `seconds`, then one
        synchronise: the window's record."""
        slam = self.slam
        it0 = dict(slam.iters_run)
        ph0 = dict(slam.stats.time_s) if slam.stats else {}
        first = self.idx
        frame_ms = []
        t_start = time.perf_counter()
        deadline = t_start + seconds
        # per frame: wall ms, and the tracking and mapping iterations it
        # ran (the program's counters: host integers, no device read)
        iters = []
        host0 = host_state()
        while True:
            before = (slam.iters_run["track"], slam.iters_run["map"])
            t = time.perf_counter()
            self.step()
            now = time.perf_counter()
            frame_ms.append((now - t) * 1e3)
            iters.append((slam.iters_run["track"] - before[0],
                          slam.iters_run["map"] - before[1]))
            if now >= deadline:
                break
        self.sync()
        wall_s = time.perf_counter() - t_start
        rec = {"first": first, "n": self.idx - first, "wall_s": wall_s,
               "frame_ms": frame_ms, "frame_iters": iters,
               "host": host_delta(host0, host_state())}
        if slam.stats is not None:
            rec["stats"] = {
                "frames": rec["n"],
                "iters": {k: slam.iters_run[k] - it0[k] for k in it0},
                "phase_s": {k: slam.stats.time_s[k] - ph0.get(k, 0.0)
                            for k in ("tracking", "mapping")}}
        return rec

    def stretch(self) -> dict:
        """torch.profiler over the traffic's whole mapping cycles, from a
        frame after a mapping frame; the reduced trace."""
        from torch.profiler import ProfilerActivity, profile
        from slambench import trace

        slam = self.slam
        self.until(1)
        n = self.traffic["profile_phases"] * self.every
        it1 = dict(slam.iters_run)
        with trace.layer_spans(slam):
            self.sync()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for _ in range(n):
                    self.step()
                self.sync()
                stretch_s = time.perf_counter() - t
        return trace.reduce(prof, stretch_s, n,
                            {k: slam.iters_run[k] - it1[k] for k in it1})

    def check(self, judged=("program",)) -> dict:
        """The next mapping frame through `step_frame` from the harness's
        checkpoint, its iterations followed by the reference:
        {judged: numbers} ("program": the program's outputs; "control":
        the reference in TF32 in its place)."""
        from slambench import check

        self.until(0)
        cap = check.Capture(self.slam, self.stream, self.cfg, self.shp,
                            self.seed, self.idx)
        with cap:
            self.step()
        # rays the reference left on a mask threshold after its redraws,
        # and each iteration's loss gaps
        self.borderline = cap.borderline()
        out, self.loss_gaps = {}, {}
        for j in judged:
            got = cap.program() if j == "program" else cap.control()
            out[j] = check.numbers(got, cap)
            self.loss_gaps[j] = check.loss_gaps(got, cap)
        return out

    def records(self, win: dict) -> dict:
        """The window's ATE (no alignment: frame 0 starts at its true
        pose) and per-frame records."""
        a, b = win["first"], win["first"] + win["n"]
        err = np.linalg.norm(self.slam.est_c2w[a:b, :3, 3]
                             - self.slam.gt_c2w[a:b, :3, 3], axis=-1)
        stats = self.slam.stats.frames if self.slam.stats else []
        return {"workload": self.cell["name"], "seed": self.seed,
                "ate_rmse_cm": float(np.sqrt(np.mean(err ** 2)) * 100),
                "frames": [{"idx": i, "ms": ms, "track_iters": it[0],
                            "map_iters": it[1], "err_cm": float(e * 100)}
                           for i, ms, it, e in zip(range(a, b),
                                                   win["frame_ms"],
                                                   win["frame_iters"], err)],
                "phase_stats": [f for f in stats if a <= f["idx"] < b],
                "iters_window": win.get("stats", {}).get("iters"),
                "host_window": win.get("host"),
                "setup_steps_s": self.setup}

    def finite_frames(self, win: dict):
        a, b = win["first"], win["first"] + win["n"]
        return np.isfinite(self.slam.est_c2w[a:b]).all(axis=(1, 2))

    def close(self) -> None:
        self.slam.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="a tiny run on the CPU (control flow only)")
    args = ap.parse_args(argv)

    from slambench import check, lib
    bench = lib.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    # kernel caches at fixed places inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    if args.rehearse:
        torch.set_num_threads(2)
    elif not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2

    ses = Session(args.workload, args.seed, bool(args.trace), args.rehearse)
    rec = {"setup_s": time.perf_counter() - T0, "shapes": ses.shp}
    win = ses.window(args.seconds)
    rec["window"] = win
    if "stats" in win:
        rec["stats"] = win["stats"]
    breakdown = None
    if args.trace and not args.rehearse:
        rec["trace"] = ses.stretch()
        breakdown = rec["trace"].pop("breakdown")
    dev = ses.device
    if dev.type == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    records = ses.records(win)
    finite = ses.finite_frames(win)
    nums = ses.check()["program"]
    ses.close()
    limits = ses.limits
    correct = check.judge(nums, limits) and bool(finite.all())

    bad = forbidden_modules()
    if bad:
        print(f"slambench: the run loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3

    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        if args.rehearse and m["source"] == "device_trace":
            continue
        v = lib.load_module("metrics", m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if dev.type == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                  "count": chips, "memory_peak_bytes": rec["peak_bytes"]}
    else:
        device = {"platform": "cpu", "kind": "cpu (rehearsal)", "count": 1,
                  "memory_peak_bytes": 0}
    if "trace" in rec:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["wall_s"]
    records["numbers"] = nums
    records["borderline_rays"] = ses.borderline
    records["loss_gaps"] = ses.loss_gaps["program"]
    out_dir = Path(os.environ.get("TMPDIR") or ROOT / "build" / "slambench")
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / (f"slambench-{args.workload}-{args.seed}-"
                         f"trace{args.trace}.json"), "w") as f:
        json.dump(records, f)
    print("records " + json.dumps(records))
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    result = {"correct": correct, "attempted": win["n"],
              "failed": int((~finite).sum()), "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
