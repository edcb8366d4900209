"""Port parity for the fused decoder variant (`grid.tcnn_network: true`,
kernel K4's plain version, `unislam_tpu_torch.kernels.fused_mlp`) against
the JAX package's bias-free `mlp_apply` and its VJP (`jax.vjp`), at the
decoder's widths: brick features 3 x 8 = 24, hash features 16 x 2 = 32,
hidden 16, heads of 1 (tanh) and 3 (sigmoid) outputs.

Tolerance (`chip_smoke.k4_misfit`): one bf16 ulp of each element's
magnitude plus 2^-8 of its sum of |terms|, at most 1% of an output's
elements (or 2) off by more than 2^-16 of their terms, and the weight
gradients bf16 values. The two frameworks
sum the same terms in other orders in f32, so a bf16 rounding point
(hidden unit, hidden and input gradient, weight gradient) can land one
bf16 step apart, but only rarely; a computation without one of the
rounding points fails the check (`test_k4_check_*`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from unislam_tpu.models import decoders as jdec
from unislam_tpu_torch.kernels import fused_mlp as tfm
from unislam_tpu_torch.models import decoders as tdec


def _within(ours, ref, terms, what):
    fit = chip_smoke.k4_misfit(torch.tensor(np.array(ours)),
                               torch.tensor(np.array(ref)), terms,
                               rounded=what.startswith("dW"))
    assert fit["ok"], (what, fit)


def _params(in_dim, out_dim, seed):
    return jax.tree_util.tree_map(np.asarray, jdec.init_fused_mlp(
        jax.random.PRNGKey(seed), in_dim, 16, out_dim, 2))


def _torch_params(p):
    return {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}


def _features(n, in_dim, seed):
    """Features at the scale of trained tables, with the rows the kernel
    must also get right: exact zeros (every pre-activation 0, where ReLU's
    derivative is JAX's 0.5), values on bf16 rounding ties, and large
    values that saturate tanh and sigmoid."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.5, size=(n, in_dim)).astype(np.float32)
    x[:4] = 0.0
    ties = (1.0 + (2 * rng.integers(0, 64, (4, in_dim)) + 1) / 256.0)
    x[4:8] = (ties * rng.choice([-1.0, 1.0], (4, in_dim))).astype(np.float32)
    x[8:12] = rng.choice([-3e3, 3e3], (4, in_dim)).astype(np.float32)
    return x


@pytest.mark.parametrize("in_dim", [24, 32])
@pytest.mark.parametrize("act,out_dim", [("tanh", 1), ("sigmoid", 3),
                                         ("none", 3)])
def test_fused_mlp_matches_jax_vjp(in_dim, act, out_dim):
    params = _params(in_dim, out_dim, in_dim + out_dim)
    x = _features(200, in_dim, in_dim)
    g = np.random.default_rng(1).normal(size=(200, out_dim)).astype(
        np.float32)
    ref, vjp = jax.vjp(lambda p, x: jdec.mlp_apply(p, x, act), params,
                       jnp.asarray(x))
    jg_p, jg_x = vjp(jnp.asarray(g))

    tp = _torch_params(params)
    tx = torch.tensor(x, requires_grad=True)
    out = tdec.mlp_apply(tp, tx, act)
    out.backward(torch.tensor(g))
    # the weight gradients' rounding point, which the mapper applies
    tfm.round_bf16_([tp["w0"].grad, tp["w1"].grad])
    b_out, b_gx, b_w0, b_w1 = chip_smoke.k4_terms(
        torch.tensor(x), [(torch.tensor(params["w0"]),
                           torch.tensor(params["w1"]), act)], torch.tensor(g))
    _within(out.detach(), ref, b_out, "out")
    _within(tx.grad, jg_x, b_gx, "g_x")
    _within(tp["w0"].grad, jg_p["w0"], b_w0, "dW0")
    _within(tp["w1"].grad, jg_p["w1"], b_w1, "dW1")
    # the weight gradients are f32 sums rounded to bf16, as JAX's (the
    # kernel's f32 sums are not: the mapper rounds them)
    for k in ("w0", "w1"):
        w = tp[k].grad
        assert torch.equal(w, w.to(torch.bfloat16).float())


@pytest.mark.parametrize("in_dim", [24, 32])
def test_decode_heads_match_jax(in_dim):
    """Both heads on shared features in one call ([r, g, b, sdf]) against
    the JAX package's two `mlp_apply`s and their concatenation: the
    feature gradient is each head's bf16 gradient, added in f32."""
    sdf_p, col_p = _params(in_dim, 1, 1), _params(in_dim, 3, 2)
    x = _features(300, in_dim, 5)
    g = np.random.default_rng(6).normal(size=(300, 4)).astype(np.float32)

    def f(sp, cp, x):
        sdf = jdec.mlp_apply(sp, x, "tanh")[..., 0]
        rgb = jdec.mlp_apply(cp, x, "sigmoid")
        return jnp.concatenate([rgb, sdf[..., None]], axis=-1)

    ref, vjp = jax.vjp(f, sdf_p, col_p, jnp.asarray(x))
    jg_s, jg_c, jg_x = vjp(jnp.asarray(g))

    ts, tc = _torch_params(sdf_p), _torch_params(col_p)
    tx = torch.tensor(x, requires_grad=True)
    out = tdec.decode_heads(ts, tc, tx)
    out.backward(torch.tensor(g))
    tfm.round_bf16_([p.grad for p in (*ts.values(), *tc.values())])
    heads = [(torch.tensor(col_p["w0"]), torch.tensor(col_p["w1"]),
              "sigmoid"),
             (torch.tensor(sdf_p["w0"]), torch.tensor(sdf_p["w1"]), "tanh")]
    b_out, b_gx, *b_w = chip_smoke.k4_terms(torch.tensor(x), heads,
                                            torch.tensor(g))
    _within(out.detach(), ref, b_out, "out")
    _within(tx.grad, jg_x, b_gx, "g_x")
    for tpar, jg, (b0, b1) in ((tc, jg_c, b_w[:2]), (ts, jg_s, b_w[2:])):
        _within(tpar["w0"].grad, jg["w0"], b0, "dW0")
        _within(tpar["w1"].grad, jg["w1"], b1, "dW1")
    # one call is the two heads called one by one
    sep = torch.cat([tdec.mlp_apply(tc, tx, "sigmoid"),
                     tdec.mlp_apply(ts, tx, "tanh")], dim=-1)
    assert torch.equal(out, sep)


def test_backward_without_weight_gradients_gives_the_same_input_gradient():
    """Frozen weights (tracking): the backward leaves the weight gradients
    out and gives the same feature gradient."""
    heads = [(torch.tensor(p["w0"]), torch.tensor(p["w1"]), a)
             for p, a in ((_params(24, 3, 3), "sigmoid"),
                          (_params(24, 1, 4), "tanh"))]
    x = torch.tensor(_features(64, 24, 7))
    g = torch.randn(64, 4, generator=torch.Generator().manual_seed(0))
    gx_w, dws = tfm.mlp_bwd(x, heads, g, need_weights=True)
    gx, none = tfm.mlp_bwd(x, heads, g, need_weights=False)
    assert none is None and len(dws) == 2 and torch.equal(gx, gx_w)
    frozen = [{"w0": w0, "w1": w1} for w0, w1, _ in heads]
    tx = x.clone().requires_grad_(True)
    tfm.apply_heads(frozen, tx, ["sigmoid", "tanh"]).backward(g)
    assert torch.equal(tx.grad, gx)


def test_fused_variant_checks_its_structure():
    with pytest.raises(ValueError):
        tdec.mlp_apply({"w0": torch.zeros(8, 16), "w1": torch.zeros(16, 16),
                        "w2": torch.zeros(16, 1)}, torch.zeros(2, 8), "tanh")
    with pytest.raises(ValueError):     # a CUDA call checks device first
        tfm.mlp_fwd(torch.zeros(2, 8, device="meta"),
                    [(torch.zeros(8, 16), torch.zeros(16, 1), "tanh")])


@pytest.mark.parametrize("control", chip_smoke.K4_CONTROLS)
def test_k4_check_fails_without_a_rounding_point(control):
    """The check that holds K4 to its plain version (on the card) and to
    JAX (here) tells the function from the same one without one of its
    bf16 rounding points, or with d rounded to bf16 before d @ W1^T and
    h^T d (a rounding point it does not have; each must fail), and passes
    the same function with every product's sum taken in another order
    (f64, then rounded), at the brick decoder's width (both heads) and
    20,000 points."""
    gen = torch.Generator().manual_seed(11)
    heads = [(torch.tensor(p["w0"]), torch.tensor(p["w1"]), a)
             for p, a in ((_params(24, 3, 5), "sigmoid"),
                          (_params(24, 1, 6), "tanh"))]
    x = torch.tensor(chip_smoke.k4_features(20_000, 24, 3))
    g = torch.randn(20_000, 4, generator=gen)
    ref = chip_smoke.k4_outputs(tfm.mlp_fwd_plain(x, heads),
                                *tfm.mlp_bwd_plain(x, heads, g))
    assert all(torch.equal(a, b) for a, b in zip(
        ref, chip_smoke.k4_planted(x, heads, g)))
    other = chip_smoke.k4_control(x, heads, g, control)
    fits = chip_smoke.k4_fits(other, ref, chip_smoke.k4_terms(x, heads, g))
    assert all(f["ok"] for f in fits) == (control == "f64"), fits


def _kernel_order(x, heads, g_out):
    """K4 as the kernel (csrc/fused_mlp.cu) orders its sums, in torch on
    the CPU: the tensor core's products (xb @ W0, z @ W0^T, xb^T z) in k16
    steps, each step's exact sum added to the f32 accumulator with one
    rounding; o = h @ W1 and g_h = d @ W1^T in f32, term by term in order;
    dW0 accumulated a 16-point tile at a time by each warp over its tiles
    (WG_BLOCKS blocks of 8 warps at most, warp w of block b taking tiles
    8b + w, then every 8 * blocks on), dW1 a point at a time within a tile;
    the 8 warps' sums in a fixed tree, the blocks' partials summed as
    `fused_mlp_wgrad_reduce` does, then bf16 (the mapper's rounding of
    the kernel's f32 sums). Returns `k4_flat`'s list."""
    tile, warps_a_block, wg_blocks = 16, 8, 264
    N = x.shape[0]
    n_tiles = -(-N // tile)
    blocks = min(-(-n_tiles // warps_a_block), wg_blocks)
    warps = blocks * warps_a_block
    rounds = -(-n_tiles // warps)
    pad = rounds * warps * tile - N

    def k16(a, b):
        acc = torch.zeros(a.shape[0], b.shape[1])
        for k in range(0, a.shape[1], 16):
            acc = (acc.double() + a[:, k:k + 16].double()
                   @ b[k:k + 16].double()).float()
        return acc

    def tiles(v):
        v = torch.cat([v, v.new_zeros(pad, *v.shape[1:])])
        return v.reshape(rounds, warps, tile, *v.shape[1:])

    def reduce(acc):
        """(warps, ...) sums -> bf16 of the blocks' fixed-order sum."""
        v = acc.reshape(blocks, warps_a_block, *acc.shape[1:])
        while v.shape[1] > 1:
            v = v[:, 0::2] + v[:, 1::2]
        v = v[:, 0]
        part = [torch.zeros_like(v[0]) for _ in range(8)]
        for b in range(blocks):
            part[b % 8] = part[b % 8] + v[b]
        total = part[0]
        for y in range(1, 8):
            total = total + part[y]
        return tfm._bf16(total)

    xb = tfm._bf16(x)
    outs, g_x, dws, col = [], None, [], 0
    for w0, w1, act in heads:
        w0b, w1b = tfm._bf16(w0), tfm._bf16(w1)
        od = w1.shape[1]
        a = k16(xb, w0b)
        h = tfm._bf16(torch.relu(a))
        o = torch.zeros(N, od)
        for j in range(16):
            o = o + h[:, j:j + 1] * w1b[j]
        t = tfm._activate(o, act)
        outs.append(t)
        g = g_out[:, col:col + od]
        col += od
        if act == "tanh":
            w = g * (1.0 - t)
            d = w + w * t
        else:
            d = g * (t * (1.0 - t)) if act == "sigmoid" else g
        gh = torch.zeros(N, 16)
        for c in range(od):
            gh = gh + d[:, c:c + 1] * w1b[:, c]
        mask = torch.where(a > 0, 1.0, torch.where(a == 0, 0.5, 0.0))
        z = tfm._bf16(gh) * mask
        gx = tfm._bf16(k16(z, w0b.t()))
        g_x = gx if g_x is None else g_x + gx
        xt, zt, ht, dt = tiles(xb), tiles(z), tiles(h), tiles(d)
        s0 = torch.einsum("rwpk,rwpj->rwkj", xt.double(), zt.double())
        acc0 = torch.zeros(warps, x.shape[1], 16)
        acc1 = torch.zeros(warps, 16, od)
        for r in range(rounds):
            acc0 = (acc0.double() + s0[r]).float()
            s1 = torch.zeros(warps, 16, od)
            for q in range(tile):
                s1 = s1 + ht[r, :, q, :, None] * dt[r, :, q, None, :]
            acc1 = acc1 + s1
        dws.append((reduce(acc0), reduce(acc1)))
    return chip_smoke.k4_flat(torch.cat(outs, dim=-1), g_x, dws)


@pytest.mark.parametrize("width", ["brick", "hash"])
def test_kernel_sum_order_passes_the_k4_check(width):
    """The tensor core's k16 grouping, the CUDA cores' term-by-term sums
    and the weight gradients' per-warp, fixed-tree and per-block order,
    transcribed on the CPU, pass `chip_smoke.k4_misfit` against the plain
    version at both decoder widths (brick: in 24, both heads; hash: in 32,
    the SDF head), on features with exact zeros, bf16 ties and saturating
    rows: the check admits the kernel's order, as it refuses a missing or
    an extra rounding point (`test_k4_check_fails_without_a_rounding_point`).
    """
    gen = torch.Generator().manual_seed(13)
    in_dim, spec = {"brick": (24, ((3, "sigmoid", 5), (1, "tanh", 6))),
                    "hash": (32, ((1, "tanh", 7),))}[width]
    heads = [(torch.tensor(p["w0"]), torch.tensor(p["w1"]), act)
             for p, act in ((_params(in_dim, od, seed), act)
                            for od, act, seed in spec)]
    x = torch.tensor(chip_smoke.k4_features(20_000, in_dim, 4, True))
    x[:10_000] = torch.tensor(chip_smoke.k4_features(10_000, in_dim, 5))
    out_cols = sum(w1.shape[1] for _, w1, _ in heads)
    g = torch.randn(20_000, out_cols, generator=gen)
    ref = chip_smoke.k4_outputs(tfm.mlp_fwd_plain(x, heads),
                                *tfm.mlp_bwd_plain(x, heads, g))
    ours = _kernel_order(x, heads, g)
    fits = chip_smoke.k4_fits(ours, ref, chip_smoke.k4_terms(x, heads, g))
    assert all(f["ok"] for f in fits), fits
