"""Port parity for multi-device execution (`unislam_tpu_torch.parallel`):
the ray and table-row layouts against the JAX package's shardings on the
conftest's 8 CPU devices; the tiny problem's mapping step, tracking frame
and SLAM loop on 2 real processes (`torch.distributed` on gloo, the
worker `python -m unislam_tpu_torch.parallel.sim`) against one process
and against the JAX package's `parallel.sim` on its 8-device mesh; the
environment contract; the replica check's control.

The workers import no JAX: the parent process writes the JAX problem's
parameters, bank and draws to an .npz (`--draws`).

Tolerances: 2 processes against 1, as `tests/test_multihost.py` holds
JAX's 2 processes against 1: the loss rtol 1e-6, per-leaf checksums (sum
of |x|) rtol 1e-5, the SLAM loop's poses atol 1e-2 and losses rtol 1e-3
(Adam flips the update's sign on near-zero table gradients under any
change of summation order). The port's one process against JAX: the
brick lockstep tests' tolerances (`tests/test_torch_lod.py`). Row-sharded
tables on 2 processes against the same 2 processes without them: bit for
bit (the SLAM loop, and the smoke's rank worker `scripts/smoke_rank.py`).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_engine import _check_step, _close, _leaves
from test_torch_lod import _check_tree_grads, _record_table_rows, _table_tol
from unislam_tpu.engine import mapper as jmapper
from unislam_tpu.models import scene as jscene
from unislam_tpu.parallel import sharding as jsh
from unislam_tpu.parallel import sim as jsim
from unislam_tpu_torch.parallel import distributed as tdist
from unislam_tpu_torch.parallel import sharding as tsh
from unislam_tpu_torch.parallel import sim as tsim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS, NI = tsim.RC.n_stratified, tsim.RC.n_importance
MODES = ("step", "step+shard", "step+shard+bf16", "track", "slam",
         "slam+shard", "slam+bf16", "slam+shard+bf16", "replicas")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mesh_positions(mesh):
    return {d: i for i, d in enumerate(mesh.devices.flat)}


# ---------------------------------------------------------------- layouts

@pytest.mark.parametrize("n", [240, 4200])
def test_ray_block_matches_jax_shards(n):
    mesh = jsh.make_mesh(8)
    x = jax.device_put(jnp.arange(n), jsh.ray_sharding(mesh))
    pos = _mesh_positions(mesh)
    for shard in x.addressable_shards:
        sl = shard.index[0]
        assert tsh.ray_block(n, pos[shard.device], 8) == (sl.start,
                                                           sl.stop)
        a, b = tsh.ray_block(n, pos[shard.device], 8)
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      np.arange(n)[a:b])


def test_uneven_ray_blocks_cover_every_ray_once():
    for n in (1, 7, 241, 4201, 2_238_840):
        for world in (1, 2, 3, 5, 8):
            seen = np.zeros(n, np.int64)
            for r in range(world):
                a, b = tsh.ray_block(n, r, world)
                assert 0 <= a <= b <= n
                seen[a:b] += 1
            assert (seen == 1).all(), (n, world)
    rays = torch.arange(10)
    assert tsh.shard_rays(None, rays) is rays
    group = tdist.RayGroup(None, 2, 3)
    np.testing.assert_array_equal(tsh.shard_rays(group, rays), [8, 9])


@pytest.mark.parametrize("encoding", ["hash", "brick"])
def test_scene_param_layout_matches_jax(encoding):
    import dataclasses
    sc = jsim.build_tiny_mapping_problem().sc
    sc = dataclasses.replace(sc, encoding=encoding)
    params = jscene.init_params(jax.random.PRNGKey(0), sc)
    mesh = jsh.make_mesh(8)
    from unislam_tpu_torch.models import scene as tscene
    tparams = tscene.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    for shard_tables in (False, True):
        specs = jsh.scene_param_shardings(mesh, params,
                                          shard_tables=shard_tables)
        layout = tsh.scene_param_layout(tparams, shard_tables)
        ref = {k: ("rows" if s.spec == P("rays", None) else "replicated")
               for k, s in _leaves(jax.tree_util.tree_map(
                   lambda s: s, specs, is_leaf=lambda s: isinstance(
                       s, NamedSharding)))}
        got = dict(_leaves(layout))
        assert got == ref, (shard_tables, got, ref)
        rows = [k for k, v in got.items() if v == "rows"]
        assert rows == ([] if not shard_tables else
                        ["table"] if encoding == "brick" else
                        ["color_table", "sdf_table"])
        assert tsh.sharded_keys(tparams, shard_tables) == tuple(
            k for k in tparams if got.get(k) == "rows")


def test_table_row_block_matches_jax_row_shards():
    p = jsim.build_tiny_mapping_problem(mesh=jsh.make_mesh(8),
                                        shard_tables=True)
    table = p.opt_tree["scene"]["table"]
    n_rows = table.shape[0]
    pos = _mesh_positions(jsh.make_mesh(8))
    assert table.sharding.spec == P("rays", None)
    for shard in table.addressable_shards:
        sl = shard.index[0]
        a, b = tsh.table_row_block(n_rows, pos[shard.device], 8)
        assert (sl.start or 0, min(sl.stop or n_rows, n_rows)) == (a, b)
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      np.asarray(table)[a:b])


# ---------------------------------------------------- the tiny problem

def _render_draws(key, n):
    k_surf, k_uni, k_pdf = jax.random.split(key, 3)
    return {"t_depth": np.asarray(jax.random.uniform(k_surf, (n, NS + NI))),
            "t_uni": np.asarray(jax.random.uniform(k_uni, (n, NS))),
            "u_pdf": np.asarray(jax.random.uniform(k_pdf, (n, NI)))}


def _flat(tree, prefix):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in _leaves(tree)}


@pytest.fixture(scope="module")
def jax_problem():
    """The JAX tiny problem on the 8-device mesh: its state and draws (as
    numpy), one mapping step and one tracking frame."""
    mesh = jsh.make_mesh(8)
    p = jsim.build_tiny_mapping_problem(mesh=mesh)
    params = jax.tree_util.tree_map(np.asarray, p.opt_tree["scene"])
    bank = {k: np.asarray(getattr(p.bank, k)) for k in p.bank._fields}
    state = {**_flat(params, "params"), **_flat(bank, "bank")}

    key = jax.random.PRNGKey(3)
    mc = jmapper.MapperConfig(pixels=240, iters=1, extra_rays=64)
    n = mc.pixels + mc.extra_rays
    k_slot, k_extra, k_pix_b, k_pix_c, k_render = jax.random.split(key, 5)
    step_draws = {
        "slot": np.asarray(jnp.concatenate([
            jax.random.categorical(k_slot, jnp.log(p.probs + 1e-20),
                                   shape=(mc.pixels,)),
            jax.random.categorical(k_extra, jnp.log(p.extra_probs + 1e-20),
                                   shape=(mc.extra_rays,))])),
        "pix_b": np.asarray(jax.random.randint(k_pix_b, (n,), 0, 64)),
        "pix_c": np.asarray(jax.random.randint(k_pix_c, (n,), 0, 24 * 32)),
        **_render_draws(k_render, n)}
    state.update({f"step/{k}": v for k, v in step_draws.items()})
    for it in range(2):
        k_pix, k_render = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(11), it))
        kj, ki = jax.random.split(k_pix)
        state.update({f"track/{it}/{k}": v for k, v in {
            "j": np.asarray(jax.random.randint(kj, (240,), 2, 22)),
            "i": np.asarray(jax.random.randint(ki, (240,), 2, 30)),
            **_render_draws(k_render, 240)}.items()})

    loss_fn = jmapper.make_loss_fn(p.sc, p.rc, mc, p.intr, 4, 64)
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(
        p.opt_tree, p.bank, p.depth, p.color, p.rays_d, p.probs,
        p.extra_probs, p.pose_grad_mask, key)
    new_tree, _, loss = jsim.run_tiny_step(p)
    track = jsim.run_tiny_track_frame(p, mesh=mesh, n_iters=2)
    return {"state": state, "params": params,
            "poses": np.asarray(p.opt_tree["poses"]),
            "loss": float(loss), "grad_loss": float(jl),
            "grads": jax.tree_util.tree_map(np.asarray, jg),
            "new": jax.tree_util.tree_map(np.asarray, new_tree),
            "checksums": jsim.param_checksums(new_tree),
            "track": [np.asarray(x) for x in track[2:]]
            + [np.concatenate([np.asarray(track[0]["R"]),
                               np.asarray(track[0]["T"])])]}


@pytest.fixture(scope="module")
def state_file(jax_problem, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("par") / "state.npz")
    np.savez(path, **jax_problem["state"])
    return path


@pytest.fixture(scope="module")
def two_processes(state_file, tmp_path_factory):
    """Every mode on 2 gloo processes (one launch)."""
    out = str(tmp_path_factory.mktemp("par2") / "result.json")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "unislam_tpu_torch.parallel.sim", str(port),
         "2", str(rank), ",".join(MODES), out, "--draws", state_file,
         "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def one_process(state_file):
    """The same modes in this process, one rank (no process group)."""
    from unislam_tpu_torch.parallel.sim import _load_state, run_modes
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        # (at one rank no table is row-sharded: the slam+shard modes
        # would repeat slam and slam+bf16)
        return run_modes([m for m in MODES if m != "replicas" and not (
            m.startswith("slam") and "shard" in m)], None,
                         torch.device("cpu"), _load_state(state_file))
    finally:
        torch.set_num_threads(threads)


def test_one_process_step_matches_jax(jax_problem, state_file, monkeypatch):
    """The port's step on the JAX problem's state and draws against the
    JAX step on the 8-device mesh: loss, every leaf's gradient (the table
    within 2^-7 of each element's sum of |terms|), the Adam-updated
    leaves."""
    from unislam_tpu_torch.parallel.sim import (_draws, _load_state,
                                                build_tiny_mapping_problem,
                                                run_tiny_step)
    state = _load_state(state_file)
    p = build_tiny_mapping_problem(state=state)
    calls = _record_table_rows(monkeypatch)
    st = run_tiny_step(p, _draws(state, "step", "cpu"))
    _close(st.loss, jax_problem["loss"], rtol=1e-5)
    _close(st.loss, jax_problem["grad_loss"], rtol=1e-5)
    jg = jax_problem["grads"]
    _check_tree_grads(st.leaves, jg["scene"],
                      _table_tol(calls, p.mapper.sc.brick_spec))
    new = dict(_leaves(jax_problem["new"]["scene"]))
    old = dict(_leaves(jax_problem["params"]))
    ref_g = dict(_leaves(jg["scene"]))
    for k, v in _leaves(st.scene):
        if k == "beta":
            # one step of 0.001 from 10: the f32 spacing there (9.5e-7)
            # exceeds `_check_step`'s 1e-7; the value itself is JAX's
            _close(v, new[k], rtol=0, atol=0)
            continue
        lr = 0.05 if k == "table" else 0.001
        _check_step(v, new[k], old[k], ref_g[k], lr)
    # on this scene (constant depth and colour) the pose gradient cancels
    # to about 1e-6 over the rays, so its round-off is held to 1e-4 of the
    # largest element rather than `_grad_close`'s 1e-5
    g = np.asarray(jg["poses"])
    _close(st.poses.grad, g, rtol=1e-4, atol=1e-4 * np.abs(g).max())
    _check_step(st.poses.detach(), jax_problem["new"]["poses"],
                jax_problem["poses"], jg["poses"], 0.001)


@pytest.mark.parametrize("mode", ["step", "step+shard", "step+shard+bf16"])
def test_two_process_step_matches_one(mode, two_processes, one_process,
                                      jax_problem):
    two, one = two_processes[mode], one_process[mode]
    assert two_processes["world"] == 2
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-6)
    assert set(two["checksums"]) == set(one["checksums"]) == set(
        jax_problem["checksums"])
    for name, val in one["checksums"].items():
        np.testing.assert_allclose(two["checksums"][name], val, rtol=1e-5,
                                   err_msg=name)
    if "shard" in mode:
        # rank 0's rows: ceil(n / 2) of the brick table
        (a, b), = two["rows"].values()
        assert a == 0 and b > 0
    if "bf16" in mode:
        assert two["k7_offset_bitwise"] is True
        assert one["k7_offset_bitwise"] is True


def test_two_process_tracking_matches_one_and_jax(two_processes,
                                                  one_process, jax_problem):
    """Loss, the batch's mean uncertainty and depth-error median, and the
    best pose: 2 processes against 1, and 1 against JAX's tracking frame
    on the mesh."""
    two, one = two_processes["track"], one_process["track"]
    np.testing.assert_allclose(two["min_loss"], one["min_loss"], rtol=1e-6)
    for k in ("unc_prev", "unc_last", "median"):
        np.testing.assert_allclose(two[k], one[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(two["best7"], one["best7"], atol=1e-7)
    np.testing.assert_allclose(two["pose7"], one["pose7"], atol=1e-6)
    best7, min_loss, unc_prev, unc_last, pose7 = jax_problem["track"]
    _close(one["min_loss"], min_loss, rtol=1e-5)
    _close(one["unc_prev"], unc_prev, rtol=1e-4, atol=1e-12)
    _close(one["unc_last"], unc_last, rtol=1e-4, atol=1e-12)
    _close(one["best7"], best7, rtol=0, atol=1e-6)
    # two Adam steps of at most lr = 0.001 each
    _close(one["pose7"], pose7, rtol=0, atol=2e-4)


def _slam_close(two, one):
    est2, est1 = np.asarray(two["est7"]), np.asarray(one["est7"])
    assert est2.shape == est1.shape == (6, 7)
    assert np.isfinite(est2).all()
    np.testing.assert_allclose(est2, est1, atol=1e-2)
    assert len(two["losses"]) == len(one["losses"]) >= 3
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-3)


def test_two_process_tiny_slam_matches_one(two_processes, one_process):
    _slam_close(two_processes["slam"], one_process["slam"])


def test_two_process_tiny_slam_with_bf16_state_matches_one(two_processes,
                                                          one_process):
    """As `test_two_process_tiny_slam_matches_one`, with bf16-state Adam
    (the table stepped by K7's plain version)."""
    _slam_close(two_processes["slam+bf16"], one_process["slam+bf16"])


@pytest.mark.parametrize("mode", ["slam+shard", "slam+shard+bf16"])
def test_two_process_row_sharded_slam_is_bitwise_the_unsharded(
        mode, two_processes):
    """Row-sharded tables on 2 processes against the same 2 processes
    without them, bit for bit over the whole loop: poses, every mapping
    loss and the final scene. On 2 ranks gloo's sum of two terms does not
    depend on their order, a gather adds only zeros, and a row block's
    Adam step (K7's plain version with the block's offset for bf16 state)
    is bitwise the whole table's rows, so nothing but the layout differs."""
    got, ref = two_processes[mode], two_processes[mode.replace("+shard",
                                                               "")]
    assert np.array_equal(np.asarray(got["est7"]), np.asarray(ref["est7"]))
    assert got["losses"] == ref["losses"] and len(got["losses"]) >= 3
    assert got["scene_bits"] == ref["scene_bits"]
    assert "/table" in got["scene_bits"]


def test_replica_check_fails_when_one_rank_differs(two_processes):
    rep = two_processes["replicas"]
    assert rep["compared"] >= 10           # agreed before the change
    assert rep["raised_after_perturb"] is True


# ---------------------------------------------------------- the contract

def test_environment_contract_without_variables_is_a_noop():
    for var in ("UNISLAM_COORDINATOR", "UNISLAM_NUM_PROCESSES",
                "UNISLAM_PROCESS_ID"):
        assert var not in os.environ
    assert tdist.initialize_from_env() == 0
    assert not torch.distributed.is_initialized()
    assert tdist.global_ray_group() is None
    assert tdist.host_ray_groups() is None
    tree = {"a": torch.ones(3)}
    assert tdist.replicate(tree, None) is tree
    assert tsh.assert_replicas_agree(tree, None) == 1


def test_n_devices_other_than_the_world_size_raises():
    from unislam_tpu_torch.engine.slam import UniSLAM
    cfg, ds = tsim.tiny_slam_config(2, data_parallel=True)
    for n in (None, 1):
        cfg["parallel"]["n_devices"] = n
        slam = UniSLAM(cfg, ds, device="cpu")
        assert slam.group is None and slam.rank == 0
        slam.close()
    cfg["parallel"]["n_devices"] = 2
    with pytest.raises(ValueError, match="n_devices"):
        UniSLAM(cfg, ds, device="cpu")


def test_fused_weight_gradients_round_after_the_ranks_sum():
    """K4's weight gradients are f32 sums, which a data-parallel rank sums
    over the ranks and rounds then (`Mapper.backward`): with the batch
    split in two, the sum of the halves' gradients is within f32 round-off
    of the whole batch's, and rounded, within one bf16 step of the whole
    batch's rounded."""
    from unislam_tpu_torch.kernels import fused_mlp as fm

    g = torch.Generator().manual_seed(0)
    x = torch.randn(300, 24, generator=g)
    heads = [(torch.randn(24, 16, generator=g) * 0.3,
              torch.randn(16, 1, generator=g) * 0.3, "none"),
             (torch.randn(24, 16, generator=g) * 0.3,
              torch.randn(16, 3, generator=g) * 0.3, "sigmoid")]
    g_out = torch.randn(300, 4, generator=g)
    _, whole = fm.mlp_bwd(x, heads, g_out)
    halves = [fm.mlp_bwd(x[a:b], heads, g_out[a:b])[1]
              for a, b in ((0, 150), (150, 300))]
    for hi in range(2):
        for j in range(2):
            u = whole[hi][j]
            assert not torch.equal(u, u.to(torch.bfloat16).float())
            r = u.clone()
            fm.round_bf16_([r])
            s = halves[0][hi][j] + halves[1][hi][j]
            torch.testing.assert_close(s, u, rtol=1e-5, atol=1e-6)
            fm.round_bf16_([s])
            # the sums differ by f32 round-off, which moves a bf16
            # rounding by at most one step
            assert ((s - r).abs() <= 2.0 ** -8 * r.abs() + 1e-30).all()


def _start_ranks(tmp_path, frames_dir, name, cfg):
    """2 gloo processes of `scripts/smoke_rank.py` on the CPU, started."""
    run = tmp_path / name
    run.mkdir()
    with open(run / "config.json", "w") as f:
        json.dump(cfg, f, default=np.ndarray.tolist)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    return run, [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "smoke_rank.py"),
         str(port), "2", str(rank), str(run / "config.json"),
         str(frames_dir), str(run / "out"), "--device", "cpu", "--backend",
         "gloo", "--timeout", "100"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]


def test_drive_worker_on_two_ranks(tmp_path):
    """`scripts/smoke_rank.py` (the smoke's ranks) on 2 gloo processes:
    the toy scene with the fused decoders and bf16-state Adam, 3 frames,
    with row-sharded tables and without. Each rank's first mapping
    iteration matches one rank on the same draws, K7's row block matches
    the whole table's rows bitwise, the replicas agree after every mapping
    phase, both ranks end on the same trajectory, and the row-sharded run
    is the run without bit for bit (trajectory and final scene), as the
    smoke holds dp_brick_rows to dp_brick."""
    runs = {}
    for name, shard in (("rows", True), ("whole", False)):
        cfg, ds = tsim.tiny_slam_config(3, True, shard_tables=shard)
        cfg["grid"]["tcnn_network"] = True
        cfg["mapping"]["adam_state_dtype"] = "bfloat16"
        if not runs:
            frames = [ds[i] for i in range(3)]
            for i, key in enumerate(("color", "depth", "pose")):
                np.save(tmp_path / f"{key}.npy",
                        np.stack([f[i] for f in frames]).astype(np.float32))
        runs[name] = _start_ranks(tmp_path, tmp_path, name, cfg)
    procs = [p for _, ps in runs.values() for p in ps]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    reps = {name: [json.load(open(run / "out" / f"rank{r}.json"))
                   for r in range(2)] for name, (run, _) in runs.items()}
    for name, ranks in reps.items():
        for r, rep in enumerate(ranks):
            first = rep["first_step"]
            assert first["ok"], first
            assert rep["replica_checks"] == rep["mapping_cnt"] == 3
            assert rep["allreduce_per_map_iter"]["calls"] >= 2
        assert ranks[0]["est_c2w"] == ranks[1]["est_c2w"]
        assert ranks[0]["scene_checksum"] == ranks[1]["scene_checksum"]
    for r, rep in enumerate(reps["rows"]):
        assert rep["first_step"]["k7_offset_bitwise"] is True
        (rows,) = rep["table_rows"].values()
        assert rows["rows"] == list(tsh.table_row_block(rows["of"], r, 2))
        assert rep["table_adam_state_bytes"] == rep["table_block_bytes"]
    assert not reps["whole"][0]["table_rows"]
    assert reps["rows"][0]["est_c2w"] == reps["whole"][0]["est_c2w"]
    assert reps["rows"][0]["scene_checksum"] == \
        reps["whole"][0]["scene_checksum"]
