"""The harness end to end on the CPU at a tiny size (`run.py
--rehearse`), the output check's faults and control, and what a run does
without a card or without the program."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from slambench import check  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "unislam_tpu")
CELL = "replica_room0_hash.holes"


def _run(args, cwd=ROOT, timeout=600):
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "slambench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.fixture(scope="module")
def session():
    import torch
    from slambench.run import Session

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    ses = Session(CELL, 2 ** 31 + 77, rehearse=True)
    ses.window(0.5)
    yield ses
    ses.close()
    torch.set_num_threads(threads)


def test_rehearsal_runs_the_whole_flow(tmp_path):
    r = _run(["--workload", CELL, "--seed", str(2 ** 31 + 5), "--seconds",
              "1", "--trace", "1", "--rehearse"])
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    assert lines[-2].startswith("records ")
    assert res["correct"] is True and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    # no device metric from a CPU run
    assert "device_idle_share" not in res["metrics"]
    assert "track_ms_per_iter" in res["metrics"]
    assert res["device"]["platform"] == "cpu"
    tail = r.stderr.strip().splitlines()[-len(check.NUMBERS):]
    assert [t.split()[1] for t in tail] == list(check.NUMBERS)


@pytest.mark.parametrize("fault", ["adam_noop", "track_adam_noop",
                                   "half_batch", "encode_off"])
def test_a_planted_fault_fails_the_check(session, fault):
    from slambench.faults import FAULTS

    with FAULTS[fault]():
        nums = session.check()["program"]
    assert not check.judge(nums, session.limits), nums


def test_the_sound_program_passes_and_the_control_fails(session):
    got = session.check(("program", "control"))
    assert check.judge(got["program"], session.limits), got["program"]
    assert not check.judge(got["control"], session.limits), got["control"]


def test_a_run_without_a_card_fails_without_a_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(["--workload", CELL, "--seed", "1", "--seconds", "1"])
    assert r.returncode == 2 and r.stdout.strip() == ""


def test_a_run_without_the_program_fails_without_a_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "slambench"), tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(["--workload", CELL, "--seed", "1", "--seconds", "1",
              "--rehearse"], cwd=tmp_path)
    assert r.returncode != 0 and "{" not in r.stdout


def test_nothing_the_benchmark_loads_is_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import slambench.run, slambench.check, slambench.trace,"
            " slambench.calibrate, slambench.faults;"
            "from slambench import lib; b = lib.benchmark();"
            "[lib.load_module('metrics', m['name']) for m in"
            " b['end_to_end'] + b['per_layer']];"
            "import unislam_tpu_torch.engine.slam;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    loaded = set(ast.literal_eval(r.stdout.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN)
    assert "unislam_tpu_torch" in loaded   # compared whole, not by prefix


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import slambench.reference, slambench.shapes;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    loaded = set(ast.literal_eval(r.stdout.strip().splitlines()[-1]))
    assert not loaded & {"unislam_tpu_torch", *FORBIDDEN}
    for name in ("reference.py", "shapes.py"):
        tree = ast.parse(open(os.path.join(ROOT, "slambench", name)).read())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
        assert not {m.split(".")[0] for m in mods} & {
            "unislam_tpu_torch", *FORBIDDEN}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the chip)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", ["replica_room0_hash.clean",
                                  "replica_room0_hash.holes"])
def test_on_the_card_the_control_fails_at_the_cells_size(card, cell):
    from slambench.run import Session

    ses = Session(cell, 2 ** 31 + 901)
    ses.window(2.0)
    got = ses.check(("program", "control"))
    ses.close()
    assert check.judge(got["program"], ses.limits), got["program"]
    assert not check.judge(got["control"], ses.limits), got["control"]


def test_borderline_rays_are_redrawn_from_the_reference_alone():
    import torch

    def step(leaves, d, tf32):
        # rays with x under 0.5 lie on a threshold
        near = torch.where(d["x"] < 0.5, 1e-6, 1.0)
        return {"loss": d["x"].sum() + leaves["p"].sum(),
                "grad": {"p": torch.ones(1)}, "margins": near}

    def draw(i, r):
        return {"x": torch.rand(16, generator=torch.Generator().manual_seed(
            100 * i + r))}

    got = check.follow(step, {"p": torch.zeros(1)}, 3, draw, {"p": 0.1},
                       (0.9, 0.999))
    assert got["border"] == 0
    assert all(bool((d["x"] >= 0.5).all()) for d in got["draws"])
    again = check.follow(step, {"p": torch.zeros(1)}, 3, None, {"p": 0.1},
                         (0.9, 0.999), draws=got["draws"])
    assert [float(v) for v in again["losses"]] == [
        float(v) for v in got["losses"]]
    # Adam moved p by the learning rate on its first step
    assert abs(float(got["first"]["after"]["p"]) + 0.1) < 1e-6


def test_a_nan_reading_fails_its_limit():
    import torch

    ref = {"a": torch.ones(3), "b": torch.ones(2)}
    bad = {"a": torch.tensor([1.0, float("nan"), 1.0]), "b": torch.ones(2)}
    assert check._worst(ref, ref) == 0.0
    assert check._worst(bad, ref) != check._worst(bad, ref)   # NaN
    nums = {k: 0.0 for k in check.NUMBERS}
    limits = {k: 1.0 for k in check.NUMBERS}
    assert check.judge(nums, limits)
    assert not check.judge({**nums, "map_grad": float("nan")}, limits)
