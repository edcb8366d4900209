"""The port's spans and counters (`unislam_tpu_torch/utils/profiling.py`):
a small CPU drive with `profiling.enabled` on and off, the span tree it
records, the counters `UniSLAM.iters_run` declares, what `torch.profiler`
sees, the benchmark's readers of the counters, and (on the card) the
`syncs` counter against CUDA's sync debug mode.

The card's test skips without a CUDA device. On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py

(this file imports no JAX, so it runs without the test configuration).
"""

import json
import math
import os
import subprocess
import sys
import traceback
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from unislam_tpu_torch.utils import profiling  # noqa: E402

FRAMES = 6
# the benchmark's readers of the program's spans and counters:
# name -> (counter, denominator: an iteration count or "frames")
READERS = {
    "track_fwd_ms_per_iter": (("us.track.fwd",), "track"),
    "track_bwd_ms_per_iter": (("us.track.bwd",), "track"),
    "track_opt_ms_per_iter": (("us.track.opt",), "track"),
    "map_fwd_ms_per_iter": (("us.map.fwd",), "map"),
    "map_bwd_ms_per_iter": (("us.map.bwd",), "map"),
    "map_opt_ms_per_iter": (("us.map.opt",), "map"),
    "keyframe_ms_per_frame": (("us.map.select", "us.keyframes"), "frames"),
    "host_syncs_per_frame": (("syncs",), "frames"),
    "sync_wait_ms_per_frame": (("us.sync",), "frames"),
}


class _Holes:
    """A frame source with an 8x8 block of each frame's depth zeroed, so
    every mapping iteration runs the no-depth probe."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        color, depth, c2w = self.ds[i]
        depth = np.array(depth, copy=True)
        depth[4:12, 4:12] = 0.0
        return color, depth, c2w


def _slam(on: bool, device="cpu", frames=FRAMES, size=(24, 32),
          holes=False, tracking=None, mapping=None):
    from unislam_tpu_torch.core.rays import Intrinsics
    from unislam_tpu_torch.data.synthetic import SyntheticRoom, make_config
    from unislam_tpu_torch.engine.slam import UniSLAM

    H, W = size
    intr = Intrinsics(H=H, W=W, fx=0.9 * W, fy=0.9 * W, cx=W / 2 - 0.5,
                      cy=H / 2 - 0.5)
    ds = SyntheticRoom(n_frames=frames, intr=intr, deg_per_frame=1.5)
    cfg = make_config(ds, {
        "tracking": tracking or {"pixels": 64, "iters": 3,
                                 "ignore_edge_W": 2, "ignore_edge_H": 2},
        "mapping": mapping or {"pixels": 96, "iters": 2, "iters_first": 3,
                               "every_frame": 2, "keyframe_every": 2},
        "rendering": {"n_stratified": 8, "n_importance": 4},
        "profiling": {"enabled": on}})
    return UniSLAM(cfg, _Holes(ds) if holes else ds, seed=0, device=device)


def _drive(on: bool):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    slam = _slam(on)
    try:
        for i in range(FRAMES):
            slam.step_frame(i)
    finally:
        torch.set_num_threads(threads)
        slam.close()
    return slam


@pytest.fixture(scope="module")
def drives():
    return {"on": _drive(True), "off": _drive(False)}


def test_every_counter_is_declared_at_construction():
    slam = _slam(False)
    try:
        keys = set(slam.iters_run)
        assert keys == ({"track", "map", "probe", "syncs", "track_graph",
                         "map_graph", "graph_captures", "activated",
                         "extended"}
                        | {"us." + n for n in profiling.SPANS})
        assert not any(slam.iters_run.values())
    finally:
        slam.close()


def test_the_drive_opens_declared_spans_and_adds_no_counter(drives):
    on = drives["on"]
    assert set(on.iters_run) == set(drives["off"].iters_run)
    opened = set(on.stats.time_s)
    assert opened <= set(profiling.SPANS)
    # one rank on the CPU, no hooks: every span but the all-reduces, the
    # hooks and the graphed iterations' (CUDA only)
    assert opened == set(profiling.SPANS) - {
        "track.allreduce", "map.allreduce", "hooks"} - set(
        profiling.GRAPH_PARTS)


def test_loop_spans_nest_inside_their_phase(drives):
    tree = drives["on"].stats.tree
    for path in tree:
        parts = path.split("/")
        for role, phase in (("track", "tracking"), ("map", "mapping")):
            if parts[-1].startswith(role + "."):
                assert parts[0] == phase, path
    for role, phase in (("track", "tracking"), ("map", "mapping")):
        fwd = f"{phase}/{role}.iter/{role}.fwd"
        for part in ("sample", "encode", "decode", "composite", "loss"):
            assert f"{fwd}/{role}.{part}" in tree
        for part in ("bwd", "opt"):
            assert f"{phase}/{role}.iter/{role}.{part}" in tree


def test_self_time_and_children_tile_each_span(drives):
    tree = drives["on"].stats.tree
    for path, (total, own, calls) in tree.items():
        assert own >= 0 and calls > 0, path
        children = [tree[p][0] for p in tree
                    if p.rsplit("/", 1)[0] == path and "/" in p]
        assert own + sum(children) == total, path


def test_report_total_sums_the_top_level_spans(drives):
    st = drives["on"].stats
    rep = st.report()
    top = [p for p in st.tree if "/" not in p]
    assert set(top) == {n for n in st.time_s if n not in st.nested()}
    assert rep["total"]["time_s"] == round(sum(st.time_s[n] for n in top), 4)
    assert rep["total"]["calls"] == sum(st.tree[p][2] for p in top)
    # each name's self time is its total less its children's
    for name, r in rep.items():
        if name != "total":
            assert 0 <= r["self_s"] <= r["time_s"]
    # every frame's record holds its spans, the loop's parts included
    rec = st.frames[2]
    assert {"tracking", "track.fwd", "mapping", "map.bwd"} <= set(
        rec["phases"])


def test_tracing_changes_no_number_and_counts_only_when_on(drives):
    on, off = drives["on"], drives["off"]
    assert np.array_equal(on.est_c2w, off.est_c2w)
    for k, v in on.params.items():
        if isinstance(v, dict):
            for kk, t in v.items():
                assert torch.equal(t, off.params[k][kk]), (k, kk)
        else:
            assert torch.equal(v, off.params[k]), k
    for k in ("track", "map", "probe", "syncs"):
        assert on.iters_run[k] == off.iters_run[k], k
    assert on.iters_run["syncs"] > 0
    assert not any(v for k, v in off.iters_run.items() if k[:3] == "us.")
    for name in on.stats.time_s:
        # the counter is the span's integer microseconds
        assert on.iters_run["us." + name] == on.stats._ns[name] // 1000
    assert on.iters_run["us.tracking"] > 0 and on.iters_run["us.map.bwd"] > 0


def test_span_names_take_the_role_of_the_open_span():
    st = profiling.PhaseStats(counters={"us.track.encode": 0})
    assert profiling.span(".encode") is profiling.span("x")   # no-op
    with profiling.installed(st, {"syncs": 0}):
        with profiling.span("tracking"):
            with profiling.span("track.fwd"):
                with profiling.span(".encode"):
                    pass
            with profiling.span(".encode"):
                pass
        with profiling.span(".encode"):
            pass
        assert profiling.fetch(int, "7") == 7
        assert profiling._counters == {"syncs": 1}
    assert profiling._stats is None and profiling._counters is None
    assert set(st.tree) == {"tracking", "tracking/track.fwd",
                            "tracking/track.fwd/track.encode",
                            "tracking/tracking.encode", "encode", "sync"}
    assert st.nested() == {"track.fwd", "track.encode", "tracking.encode"}
    assert st.counters["us.track.encode"] == st._ns["track.encode"] // 1000


def test_fetch_counts_without_tracing():
    counters = {"syncs": 0}
    with profiling.installed(None, counters):
        assert profiling.fetch(float, torch.tensor(2.5)) == 2.5
        assert profiling.fetch(torch.Tensor.cpu, torch.ones(2)).sum() == 2
    assert counters == {"syncs": 2}
    assert profiling.fetch(float, torch.tensor(1.0)) == 1.0   # nothing


def test_the_profiler_sees_the_spans_as_host_events():
    from torch.profiler import ProfilerActivity, profile

    slam = _slam(True, frames=3)
    try:
        slam.step_frame(0)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            slam.step_frame(1)
            slam.step_frame(2)
    finally:
        slam.close()
    names = {e.name for e in prof.events()}
    for n in ("tracking", "track.iter", "track.fwd", "track.encode",
              "track.decode", "track.sample", "track.composite",
              "track.loss", "track.bwd", "track.opt", "track.init",
              "mapping", "map.iter", "map.fwd", "map.encode", "map.bwd",
              "map.opt", "map.select", "map.setup", "map.gather",
              "keyframes", "frame_fetch", "sync"):
        assert "layer:" + n in names, n
    assert not slam.stats._stack


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_metric_readers(name):
    from slambench import lib

    read = lib.load_module("metrics", name).read
    keys, denom = READERS[name]
    iters = {"track": 80, "map": 40, "probe": 0, "syncs": 50,
             **{k: 0 for k in keys if k != "syncs"}}
    for i, k in enumerate(keys):
        iters[k] = 12000 * (i + 1)
    run = {"stats": {"frames": 10, "iters": iters}}
    n = run["stats"]["frames"] if denom == "frames" else iters[denom]
    per = 1.0 if keys == ("syncs",) else 1e-3
    assert read(run) == pytest.approx(sum(iters[k] for k in keys) * per / n)
    # no stats (a run without tracing), a parent without the counter, no
    # iterations or frames: nothing to report
    assert read({}) is None
    missing = {k: v for k, v in iters.items() if k != keys[-1]}
    assert read({"stats": {"frames": 10, "iters": missing}}) is None
    zero = dict(iters, **{denom: 0}) if denom != "frames" else iters
    frames = 0 if denom == "frames" else 10
    assert read({"stats": {"frames": frames, "iters": zero}}) is None


def test_benchmark_declares_the_span_metrics():
    from slambench import lib

    per_layer = {m["name"]: m for m in lib.benchmark()["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["moves"] == "frames_per_s" and "workloads" not in m
        assert m["source"] == ("program_counter"
                               if name == "host_syncs_per_frame"
                               else "program_span")


def test_rehearsed_traced_window_reports_the_span_metrics(tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "slambench", "run.py"),
         "--workload", "replica_room0_hash.clean", "--seed", "2147483649",
         "--seconds", "3", "--trace", "1", "--rehearse"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    metrics = result["metrics"]
    for name in READERS:
        v = metrics[name]["value"]
        assert math.isfinite(v) and v >= 0, (name, v)
    # every tracked frame reads back its uncertainty and its pose
    assert metrics["host_syncs_per_frame"]["value"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("holes", [False, True], ids=["clean", "holes"])
def test_syncs_match_the_sync_debug_mode_on_the_card(holes):
    """Over 4 steady frames (two mapping phases) every call that makes the
    host wait for the device, as CUDA's sync debug mode reports them, is
    one `profiling.fetch`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_tracing.py")
    warm, steady = 6, 4
    slam = _slam(False, device="cuda", frames=warm + steady, size=(96, 128),
                 holes=holes,
                 tracking={"pixels": 800, "iters": 8, "ignore_edge_W": 6,
                           "ignore_edge_H": 6},
                 mapping={"pixels": 1000, "iters": 5, "iters_first": 10,
                          "every_frame": 2, "keyframe_every": 2})
    try:
        for i in range(warm):
            slam.step_frame(i)
        torch.cuda.synchronize()
        before = dict(slam.iters_run)
        sites = []

        def record(message, *args, **kwargs):
            # the synchronising call's place: its innermost frames
            if "synchroniz" in str(message):
                stack = traceback.extract_stack()[:-2]
                sites.append(" <- ".join(
                    f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                    for f in reversed(stack[-3:])))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            warnings.showwarning = record
            try:
                for i in range(warm, warm + steady):
                    slam.step_frame(i)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    finally:
        slam.close()
    counted = slam.iters_run["syncs"] - before["syncs"]
    assert slam.iters_run["map"] > before["map"]
    unfetched = Counter(s for s in sites if " fetch" not in s.split(" <- ")[0])
    if counted != len(sites) or unfetched:
        pytest.fail(f"fetch counted {counted}, the debug mode reported "
                    f"{len(sites)}; not through fetch:\n" + "\n".join(
                        f"{n} x {s}" for s, n in unfetched.most_common()))
