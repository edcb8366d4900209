"""Port parity for the bf16-state Adam of `unislam_tpu_torch.core.optim`
(the option `mapping.adam_state_dtype: bfloat16`, kernel K7's plain
version) against `unislam_tpu/core/optim.py`.

Everything here is held BITWISE, NaN payloads included: the stochastic and
nearest roundings, the step constants, and 30 Adam steps of a two-leaf
tree (params and both moments after every step). The JAX side runs op by
op (`jax.disable_jit()`): under `jax.jit` XLA's CPU backend may contract
`m*b1 + g*(1-b1)` into a fused multiply-add, which neither the plain
version nor the kernel (built with -fmad=false) does. One exception, not
of the port's making: a sum of two NaNs has the payload of one of them
(IEEE 754 leaves which open; x86 returns its first operand, and both
frameworks' compilers may swap the operands of an add), so where both
operands of the last add were NaN the result is held to being NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unislam_tpu.core import optim as joptim
from unislam_tpu.engine import mapper as jmapper
from unislam_tpu_torch.core import optim as toptim
from unislam_tpu_torch.engine import mapper as tmapper

# NaNs with payloads (one only in the low 16 bits), +-inf, f32 max, the
# smallest subnormal, exact bf16 values and zeros of both signs
SPECIAL = np.array([0x7F800001, 0x7FC00000, 0xFF800001, 0x7FA00001,
                    0x7F810000, 0xFFC12345, 0x7F800000, 0xFF800000,
                    0x7F7FFFFF, 0xFF7FFFFF, 0x00000001, 0x80000001,
                    0x3F800000, 0xBF810000, 0x00000000, 0x80000000],
                   np.uint32).view(np.float32)


def _bits16(x):
    return np.asarray(x).view(np.uint16) if isinstance(x, np.ndarray) \
        else x.view(torch.int16).numpy().view(np.uint16)


def _bits32(x):
    a = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32)


def _inputs(shape, seed):
    """Normals at several magnitudes with the SPECIAL values spread in."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-30, 30, shape)
         ).astype(np.float32)
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, len(SPECIAL), replace=False)] = SPECIAL
    return x


@pytest.mark.parametrize("salt", [0, 0x9E3779B9, 0xDEADBEEF, 0xFFFFFFFF])
def test_sr_round_matches_jax(salt):
    x = _inputs((37, 29), salt & 0xFFFF)
    with jax.disable_jit():
        ref = joptim._sr_round(jnp.asarray(x), jnp.uint32(salt),
                               jnp.bfloat16)
    out = toptim.sr_round_plain(torch.tensor(x), salt)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    np.testing.assert_array_equal(_bits16(out), _bits16(np.asarray(ref)))
    # the reference's guard truncates: a NaN with payload only in its low
    # 16 bits is stored as +inf / -inf
    nan_low = torch.tensor(np.array([0x7F800001, 0xFF80FFFF],
                                    np.uint32).view(np.float32))
    np.testing.assert_array_equal(
        _bits16(toptim.sr_round_plain(nan_low, salt)), [0x7F80, 0xFF80])


def test_rtn_matches_jax():
    x = _inputs((64, 9), 3)
    with jax.disable_jit():
        ref = jnp.asarray(x).astype(jnp.bfloat16)
    np.testing.assert_array_equal(
        _bits16(toptim.rtn_bf16_plain(torch.tensor(x))),
        _bits16(np.asarray(ref)))


def test_step_scalars_match_xla():
    """The bias corrections equal XLA's f32 `1 - b**count` (op by op and
    jitted) for every count a mapping phase reaches and beyond (1-300),
    and the salts the reference's uint32 arithmetic."""
    bc_jit = jax.jit(lambda b, c: 1.0 - b ** c)
    for count in range(1, 301):
        s = toptim.step_scalars(count, 3, 0.05)
        c = jnp.float32(count)
        for b, bc in ((0.9, s.bc1), (0.999, s.bc2)):
            with jax.disable_jit():
                ref = np.float32(1.0 - jnp.float32(b) ** c)
            assert np.float32(bc).view(np.uint32) == ref.view(np.uint32)
            assert np.float32(bc_jit(jnp.float32(b), c)) == ref
        salt = (jnp.uint32(count) * jnp.uint32(2654435761)) \
            ^ jnp.uint32(0x9E3779B9)
        leaf = salt ^ jnp.uint32((0x61C88647 * 7) & 0xFFFFFFFF)
        assert s.salt_m == int(leaf)
        assert s.salt_v == int(leaf ^ jnp.uint32(0xA5A5A5A5))
    s = toptim.step_scalars(1, 0, 0.05, lr_scale=5.0)
    assert (s.c1, s.c2, s.neg_lr, s.lr_scale) == (
        float(np.float32(1.0 - 0.9)), float(np.float32(1.0 - 0.999)),
        float(np.float32(-0.05)), 5.0)


def _grad_stream(shapes, n_steps, seed):
    """Per step, a gradient per leaf: normals at 1e-4 .. 1e2, a few zeros,
    and in steps 7 and 19 a NaN (payload in its low bits), +inf, -inf and a
    value whose square overflows."""
    rng = np.random.default_rng(seed)
    steps = []
    for t in range(n_steps):
        gs = []
        for shape in shapes:
            g = (rng.normal(size=shape) * 10.0 ** rng.uniform(
                -4, 2, shape)).astype(np.float32)
            flat = g.reshape(-1)
            flat[rng.choice(flat.size, 3, replace=False)] = 0.0
            if t in (7, 19):
                flat[rng.choice(flat.size, 4, replace=False)] = np.array(
                    [0x7F800001, 0x7F800000, 0xFF800000, 0x5F000000],
                    np.uint32).view(np.float32)
            gs.append(g)
        steps.append(gs)
    return steps


@pytest.mark.parametrize("state_dtype,sr", [("bfloat16", True),
                                            ("bfloat16", False),
                                            ("float32", True)])
def test_adam_lp_matches_jax_bitwise(state_dtype, sr):
    """30 steps of a two-leaf tree against `scale_by_adam_lp` +
    `optax.scale(-lr)` + the mapper's `* lr_scale` + `apply_updates`:
    params and both moments bit for bit after every step. bf16 stochastic
    rounding, the mapper's storage, runs through `AdamLP` (one group,
    leaves k = 0, 1 in the JAX tree's order); the JAX optimiser's other two
    storages, which the mapper never asks for, through `adam_lp_plain`
    alone."""
    lr, lr_scale = 0.05, 5.0
    shapes = [(40, 7), (123,)]
    rng = np.random.default_rng(1)
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jdt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    jopt = optax.chain(joptim.scale_by_adam_lp(state_dtype=jdt,
                                               stochastic_round=sr),
                       optax.scale(-lr))
    jp = {"a": jnp.asarray(p0[0]), "b": jnp.asarray(p0[1])}
    tp = [torch.tensor(p, requires_grad=True) for p in p0]
    if (state_dtype, sr) == ("bfloat16", True):
        topt = toptim.AdamLP(tp, lr=lr, lr_scale=lr_scale)
        tstates = [topt.state[p] for p in tp]
        tstep = lambda count: topt.step()  # noqa: E731
    else:
        tdt = torch.bfloat16 if state_dtype == "bfloat16" else torch.float32
        tstates = [{"m": torch.zeros(p.shape, dtype=tdt),
                    "v": torch.zeros(p.shape, dtype=tdt)} for p in tp]

        def tstep(count):
            for k, (p, st) in enumerate(zip(tp, tstates)):
                s = toptim.step_scalars(count, k, lr, lr_scale)
                new = toptim.adam_lp_plain(p.detach(), p.grad, st["m"],
                                           st["v"], s, sr)
                p.data.copy_(new[0])
                st["m"], st["v"] = new[1], new[2]
    isnan = lambda x: np.isnan(np.asarray(x, np.float32))  # noqa: E731
    with jax.disable_jit():
        state = jopt.init(jp)
        for t, gs in enumerate(_grad_stream(shapes, 30, 2)):
            prev = (jp, state[0])
            upd, state = jopt.update({"a": jnp.asarray(gs[0]),
                                      "b": jnp.asarray(gs[1])}, state, jp)
            upd = jax.tree_util.tree_map(
                lambda u: u * jnp.float32(lr_scale), upd)
            jp = optax.apply_updates(jp, upd)
            for p, g in zip(tp, gs):
                p.grad = torch.tensor(g)
            tstep(t + 1)
            for i, key in enumerate(("a", "b")):
                st = tstates[i]
                assert st["m"].dtype == (torch.bfloat16 if jdt == jnp.bfloat16
                                         else torch.float32)
                g_nan = np.isnan(gs[i])
                for ours, ref, two_nan in (
                        (tp[i], jp[key],
                         isnan(prev[0][key]) & isnan(upd[key])),
                        (st["m"], state[0].mu[key],
                         isnan(prev[1].mu[key]) & g_nan),
                        (st["v"], state[0].nu[key],
                         isnan(prev[1].nu[key]) & g_nan)):
                    ours = ours.detach().float().numpy()
                    ref = np.asarray(ref, np.float32)
                    np.testing.assert_array_equal(
                        ours[~two_nan].view(np.uint32),
                        ref[~two_nan].view(np.uint32), f"step {t}")
                    assert np.isnan(ours[two_nan]).all()
                    assert np.isnan(ref[two_nan]).all()
    if sr and state_dtype == "bfloat16":
        assert topt.param_groups[0]["count"] == 30
    assert np.isnan(tp[0].detach().numpy()).any()   # the NaN steps ran


@pytest.mark.parametrize("encoding", ["hash", "brick"])
def test_table_groups_use_leaf_index_zero(encoding):
    """The JAX mapper's own optimiser (`multi_transform` with `adam_lp` for
    the tables): after one step each table's stored moment is
    `_sr_round(g*(1-b1), salt)` with the salt of leaf index k = 0 in its
    group, and not that of k = 1. So the port's one group per table, leaf
    0, gives the same bits."""
    mc = jmapper.MapperConfig(adam_state_dtype="bfloat16")
    rng = np.random.default_rng(4)
    tables = (("sdf_table", "hash"), ("color_table", "c_hash")) \
        if encoding == "hash" else (("table", "hash"),)
    scene = {k: rng.normal(size=(50, 2)).astype(np.float32)
             for k, _ in tables}
    scene.update(sdf_mlp={"w0": np.ones((2, 2), np.float32)},
                 beta=np.ones(1, np.float32))
    tree = jax.tree_util.tree_map(jnp.asarray, {"scene": scene,
                                                "poses": np.ones((2, 7))})
    grads = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)),
        tree)
    opt = jmapper.make_optimizer(mc)
    with jax.disable_jit():
        _, state = opt.update(grads, opt.init(tree), tree)
    for key, label in tables:
        mu = np.asarray(state.inner_states[label].inner_state[0].mu[
            "scene"][key])
        g = torch.tensor(np.asarray(grads["scene"][key]))
        mf = torch.zeros_like(g) * np.float32(0.9) \
            + g * toptim.step_scalars(1, 0, 0.0).c1
        k0, k1 = (toptim.sr_round_plain(mf, toptim.step_scalars(
            1, k, 0.0).salt_m) for k in (0, 1))
        np.testing.assert_array_equal(_bits16(k0), _bits16(mu))
        assert not np.array_equal(_bits16(k1), _bits16(mu))


def test_adam_lp_skips_a_leaf_without_gradient():
    """A leaf without a gradient keeps its value and gets no state; the
    group's count still advances, as optax's does for the whole tree."""
    a, b = (torch.ones(5, requires_grad=True) for _ in range(2))
    opt = toptim.AdamLP([a, b], lr=0.1)
    a.grad = torch.ones(5)
    opt.step()
    opt.step()
    assert opt.param_groups[0]["count"] == 2
    assert torch.equal(b.detach(), torch.ones(5)) and b not in opt.state
    assert opt.state[a]["m"].dtype == torch.bfloat16
    assert (a.detach() < 1.0).all()


def test_mapper_tables_step_on_adam_lp():
    """`make_optimizer` with bfloat16 state: the tables on AdamLP (a group
    each, at their rates, scaled by lr_scale after -lr), decoders, beta and
    poses on f32 Adam with lr_scale in their rates."""
    mc = tmapper.MapperConfig(adam_state_dtype="bfloat16", lr_hash=0.05,
                              lr_c_hash=0.02, lr_decoders=0.001)
    scene = {"sdf_table": torch.zeros(8, 2, requires_grad=True),
             "color_table": torch.zeros(8, 2, requires_grad=True),
             "sdf_mlp": {"w0": torch.zeros(2, 2, requires_grad=True)},
             "beta": torch.ones(1, requires_grad=True)}
    poses = torch.zeros(3, 7, requires_grad=True)
    opt = tmapper.make_optimizer(mc, scene, poses, lr_scale=5.0)
    adam, lp = opt.opts
    assert isinstance(adam, torch.optim.Adam) and isinstance(lp,
                                                             toptim.AdamLP)
    assert [g["lr"] for g in adam.param_groups] == [0.001 * 5.0, 0.001]
    assert adam.param_groups[1]["params"] == [poses]
    assert [(g["params"], g["lr"], g["lr_scale"]) for g in lp.param_groups] \
        == [([scene["sdf_table"]], 0.05, 5.0),
            ([scene["color_table"]], 0.02, 5.0)]
    for t in (scene["sdf_table"], scene["color_table"], poses):
        t.grad = torch.ones_like(t)
    opt.step()
    assert lp.state[scene["sdf_table"]]["m"].dtype == torch.bfloat16
    # a unit gradient's first step is -lr * lr_scale (to eps and the f32
    # bias corrections)
    for key, lr in (("sdf_table", 0.05), ("color_table", 0.02)):
        assert float(scene[key].detach()[0, 0]) == pytest.approx(
            -lr * 5.0, rel=1e-5)
    opt.zero_grad()
    assert scene["sdf_table"].grad is None and poses.grad is None


def test_adam_lp_never_falls_back_off_the_cpu():
    """K7's wrapper takes CUDA tensors only, and `AdamLP` hands it every
    leaf that does not lie on the CPU: a leaf elsewhere raises rather than
    stepping with the plain version. bf16 moments only."""
    from unislam_tpu_torch.kernels import adam_lp as k7

    s = toptim.step_scalars(1, 0, 0.05)
    p = torch.zeros(8)
    with pytest.raises(ValueError):
        k7.adam_lp_step(p, p.clone(), p.bfloat16(), p.bfloat16(), s)
    meta = torch.zeros(8, device="meta", requires_grad=True)
    meta.grad = torch.zeros(8, device="meta")
    with pytest.raises(ValueError):
        toptim.AdamLP([meta], lr=0.05).step()
