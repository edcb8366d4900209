"""Port parity for the compositing kernel K3 (`unislam_tpu_torch/kernels/
composite.py`): its plain version, which CPU tensors take, against the JAX
package's compositing, composed as `render_rays` composes it:
`renderer.sdf2alpha` (unislam_tpu/render/renderer.py:80-82),
`renderer._exclusive_cumprod_weights` (:85-104) and the five sums of
`render_rays` (:206-211); the probe's weights as :151-160 form them.

Inputs come from a numpy seed. Tolerances, as the renderer's parity tests:
values rtol 1e-5 / atol 1e-6; gradients rtol 1e-4 plus 1e-5 of the
largest finite |element| (JAX forms the prefix product by reassociated
doubling, and sums in another order). NaN and inf must sit where JAX has
them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from unislam_tpu.render import renderer as jrender
from unislam_tpu_torch.kernels import build
from unislam_tpu_torch.kernels import composite as k3
from unislam_tpu_torch.models import hash_encoding as the
from unislam_tpu_torch.models import scene as tscene
from unislam_tpu_torch.render import renderer as trender

# ray sets: name -> (adversarial kind, rays, samples, beta); the adversarial
# rays are those `chip_smoke.py` holds K3 to on the card
CASES = {"s40": ("none", 64, 40, 10.0),        # the main path's S
         "s32": ("none", 48, 32, 12.0),        # the probe's S
         **{k: (k, *v) for k, v in chip_smoke.K3_ADVERSARIAL.items()}}
# the cotangents passed: all five outputs, or the SLAM loop's rgb and depth
COTANGENTS = {"all": (0, 1, 2, 3, 4), "loop": (0, 1)}


def _case(name: str):
    """raw (R, S, 4), z (R, S), beta from `chip_smoke.k3_rays`: saturated
    alpha (sdf -1 at beta 20), all-zero weights (sdf +50, std = 0) or a
    NaN sdf in the first quarter of the rays."""
    kind, R, S, beta = CASES[name]
    return chip_smoke.k3_rays(kind, R, S, beta, sorted(CASES).index(name))


def _jax_composite(raw, z, beta):
    """The JAX package's compositing, as `render_rays` composes it."""
    alpha = jrender.sdf2alpha(raw[..., 3], beta)           # :80-82
    w = jrender._exclusive_cumprod_weights(alpha)           # :85-104
    rgb = jnp.sum(w[..., None] * raw[..., :3], axis=-2)     # :206
    depth = jnp.sum(w * z, axis=-1)                         # :207
    term = jnp.sum(w, axis=-1)                              # :208
    unc = jnp.square(1.0 - term)                            # :209
    std = jnp.sqrt(jnp.sum(w * jnp.square(depth[..., None] - z),
                           axis=-1))                        # :210-211
    return rgb, depth, term, unc, std


def _cotangents(raw, seed: int):
    rng = np.random.default_rng(100 + seed)
    R = raw.shape[0]
    return [rng.normal(size=s).astype(np.float32)
            for s in ((R, 3), (R,), (R,), (R,), (R,))]


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _grad_close(a, b):
    b = np.asarray(b)
    finite = np.abs(b[np.isfinite(b)])
    top = finite.max() if finite.size else 0.0
    _close(a, b, rtol=1e-4, atol=1e-5 * max(top, 1e-12))


@pytest.mark.parametrize("cot", sorted(COTANGENTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_composite_matches_jax_vjp(case, cot):
    """Forward (five outputs) and the gradients of raw and beta: with all
    five cotangents random, or the loop's own rgb and depth (the others
    not passed, so a ray with all-zero weights gives a finite d_raw)."""
    raw, z, beta = _case(case)
    keep = COTANGENTS[cot]
    gs = _cotangents(raw, len(keep))
    j_outs = _jax_composite(jnp.asarray(raw), jnp.asarray(z), beta)
    _, vjp = jax.vjp(
        lambda r, b: [_jax_composite(r, jnp.asarray(z), b)[i] for i in keep],
        jnp.asarray(raw), jnp.float32(beta))
    j_draw, j_dbeta = vjp([jnp.asarray(gs[i]) for i in keep])

    traw = torch.tensor(raw, requires_grad=True)
    tbeta = torch.tensor(beta, requires_grad=True)
    outs = k3.composite(traw, torch.tensor(z), tbeta)
    for o, r in zip(outs, j_outs):
        _close(o.detach(), r)
    d_raw, d_beta = torch.autograd.grad(
        [outs[i] for i in keep], (traw, tbeta),
        [torch.tensor(gs[i]) for i in keep])
    _grad_close(d_raw, j_draw)
    _grad_close(d_beta, j_dbeta)
    # the card's check (`chip_smoke.k3_misfit` on each element's sum of
    # |terms|) takes the plain version against JAX too
    tz = torch.tensor(z)
    terms = chip_smoke.k3_value_terms(traw.detach(), tz, tbeta.detach())
    g_terms = chip_smoke.k3_grad_terms(
        traw.detach(), tz, tbeta.detach(),
        [torch.tensor(gs[i]) if i in keep else None for i in range(5)])
    fits = [chip_smoke.k3_misfit(o.detach(), torch.tensor(np.asarray(r)),
                                 t, False)
            for o, r, t in zip(outs, j_outs, terms)]
    fits += [chip_smoke.k3_misfit(d_raw, torch.tensor(np.asarray(j_draw)),
                                  g_terms[0], True),
             chip_smoke.k3_misfit(d_beta, torch.tensor(np.asarray(j_dbeta)),
                                  g_terms[1], True)]
    assert all(f["ok"] for f in fits), fits
    if case == "zero_weights":
        zero = slice(0, CASES[case][1] // 4)
        assert float(outs[2][zero].detach().abs().max()) == 0.0  # term
        assert float(outs[4][zero].detach().abs().max()) == 0.0  # std
    if case in ("s40", "s32", "saturated") or (case, cot) == (
            "zero_weights", "loop"):
        assert bool(torch.isfinite(d_raw).all() and torch.isfinite(d_beta))


@pytest.mark.parametrize("case", ["s32", "saturated", "nan"])
def test_probe_weights_match_jax(case):
    """The probe's weights and depth (renderer.py:151-160): no gradient."""
    raw, z, beta = _case(case)
    sdf = raw[..., 3]
    j_w = jrender._exclusive_cumprod_weights(
        jrender.sdf2alpha(jnp.asarray(sdf), beta))          # :151-153
    j_d = jnp.sum(j_w * jnp.asarray(z), axis=-1)            # :160
    tsdf = torch.tensor(sdf, requires_grad=True)
    w, d = k3.probe_weights(tsdf, torch.tensor(z), torch.tensor(beta))
    _close(w, j_w)
    _close(d, j_d)
    assert not w.requires_grad and not d.requires_grad


def test_nonzero_cumprod_backward_matches_the_product_rule_at_saturation():
    """Factors of 1e-10 (alpha = 1, the prefix product below the f32
    denormals within 5 factors): the division-free backward matches the
    float64 product rule."""
    x = np.full((3, 12), 1e-10, np.float32)
    x[:, 0] = 1.0
    x[1, 6:] = 0.5
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    tx = torch.tensor(x, requires_grad=True)
    (dx,) = torch.autograd.grad(k3._NonzeroCumprod.apply(tx), tx,
                                torch.tensor(g))
    x64, g64 = x.astype(np.float64), g.astype(np.float64)
    ref = np.zeros_like(x64)
    for j in range(x.shape[1]):
        for i in range(j, x.shape[1]):
            ref[:, j] += g64[:, i] * np.prod(np.delete(x64[:, :i + 1], j, 1),
                                             axis=1)
    _grad_close(dx, ref)


def test_composite_guards():
    """float32 only, 1 <= S <= MAX_S, matching shapes, one device of the
    CPU or CUDA; z takes no gradient; R = 0 gives empty outputs and
    launches nothing."""
    raw, z, beta = (torch.tensor(a) for a in _case("s32"))
    before = dict(build.LAUNCHES)
    with pytest.raises(TypeError):
        k3.composite(raw.double(), z, beta)
    with pytest.raises(TypeError):
        k3.probe_weights(raw[..., 3], z.double(), beta)
    wide = torch.zeros(2, k3.MAX_S + 1, 4)
    with pytest.raises(ValueError):
        k3.composite(wide, wide[..., 0], beta)
    with pytest.raises(ValueError):
        k3.composite(raw, z[:, 1:], beta)
    with pytest.raises(ValueError):
        k3.composite(raw[..., :3], z, beta)
    with pytest.raises(ValueError):
        k3.composite(raw, z, torch.ones(2))
    with pytest.raises(ValueError):
        k3.probe_weights(raw[..., 3], z[:-1], beta)
    with pytest.raises(ValueError):
        k3.composite(raw, z.requires_grad_(True), beta)
    z = z.detach()
    meta = [t.to("meta") for t in (raw, z, beta)]
    with pytest.raises(ValueError):           # neither the CPU nor CUDA
        k3.composite(*meta)
    with pytest.raises(ValueError):
        k3.probe_weights(meta[0][..., 3], meta[1], meta[2])
    with pytest.raises(ValueError):           # mixed devices
        k3.composite(raw, z, meta[2])
    outs = k3.composite(raw[:0], z[:0], beta)
    assert [tuple(o.shape) for o in outs] == [(0, 3), (0,), (0,), (0,), (0,)]
    w, d = k3.probe_weights(raw[:0, :, 3], z[:0], beta)
    assert tuple(w.shape) == (0, 32) and tuple(d.shape) == (0,)
    assert dict(build.LAUNCHES) == before


def test_kernel_path_raises_without_a_built_kernel(monkeypatch, tmp_path):
    """The CUDA path launches the kernel or raises: without a CUDA
    compiler the build fails and nothing falls back to the plain version
    (meta tensors stand in for the card's)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build, "_LIBS", {})
    raw, z, beta = (torch.tensor(a).to("meta") for a in _case("s40"))
    with pytest.raises(RuntimeError, match="nvcc"):
        k3._Composite.apply(raw, z, beta)
    with pytest.raises(RuntimeError, match="nvcc"):
        k3._probe_kernel(raw[..., 3], z, beta)
    assert build.LAUNCHES["composite_fwd"] == 0
    assert build.LAUNCHES["composite_bwd"] == 0


@pytest.mark.parametrize("no_depth", [0, 5])
def test_render_rays_composites_through_k3_on_the_cpu(monkeypatch,
                                                      no_depth):
    """`render_rays` on CPU tensors composites through `kernels/
    composite.py` (once a render, plus the probe's weights once when a ray
    lacks depth), and its outputs are K3's on the render's own raw."""
    spec = dict(n_levels=4, n_features=2, log2_hashmap_size=10,
                base_resolution=4, desired_resolution=32)
    bound = np.array([[-1.0, 1.0]] * 3, np.float32)
    sc = tscene.SceneConfig(the.make_spec(**spec), the.make_spec(**spec),
                            bound, truncation=0.1)
    params = tscene.init_params(sc, torch.Generator().manual_seed(0),
                                device="cpu")
    rc = trender.RenderConfig(n_stratified=6, n_importance=3)
    rng = np.random.default_rng(2)
    R = 24
    d = rng.normal(size=(R, 3))
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                     dtype=torch.float32)
    gd = torch.tensor(rng.uniform(0.3, 0.8, R), dtype=torch.float32)
    gd[:no_depth] = 0.0
    calls = {"composite": [], "probe": []}
    plain, probe_plain = k3.composite_plain, k3.probe_weights_plain
    monkeypatch.setattr(k3, "composite_plain", lambda *a: calls[
        "composite"].append(a) or plain(*a))
    monkeypatch.setattr(k3, "probe_weights_plain", lambda *a: calls[
        "probe"].append(a) or probe_plain(*a))
    out = trender.render_rays(params, sc, rc, torch.zeros(R, 3), d, gd,
                              torch.Generator().manual_seed(1))
    assert len(calls["composite"]) == 1
    assert len(calls["probe"]) == (1 if no_depth else 0)
    raw, z, beta = calls["composite"][0]
    assert raw.shape == (R, 9, 4) and torch.equal(z, out.z_vals)
    ref = plain(raw, z, beta)
    for got, want in zip((out.rgb, out.depth, out.termination_prob,
                          out.pixel_unc, out.depth_std), ref):
        assert torch.equal(got, want)
    assert torch.equal(out.sdf, raw[..., 3])


# ---------------------------------------------------------------------------
# K3's arithmetic order on the card (csrc/composite.cu: one warp a ray, lane
# l holding samples l and l + 32), transcribed in numpy float32, op by op.

_LANES = 32


def _lane_tree(v: np.ndarray) -> np.ndarray:
    """(R, S) slot values -> (R,): each lane adds its two slots (a slot past
    S left out), then the xor tree at offsets 16, 8, 4, 2, 1."""
    R, S = v.shape
    slots = np.zeros((R, 2 * _LANES), np.float32)
    slots[:, :S] = v
    lanes = slots[:, :_LANES] + slots[:, _LANES:]
    idx = np.arange(_LANES)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ off]
    return lanes[:, 0]


def _block_tree(p: np.ndarray) -> np.ndarray:
    """A fixed pairwise tree over the last axis (a power of two long)."""
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p[..., 0]


def _warp_transcription(raw, z, beta, gs=None):
    """K3's forward (rgb, depth, term, unc, std), probe weights, and with
    cotangents `gs` (five, None where not passed) its backward (d_raw,
    d_beta), in the kernel's order: T by the reference's doubling over the
    slots, the sums by the lanes' xor trees, A_k by the suffix scan of the
    maps (u, f), d beta by warp, block (8 rays) and last-block trees."""
    f32 = np.float32
    raw, z, b = raw.astype(f32), z.astype(f32), f32(beta)
    R, S, _ = raw.shape
    sdf = raw[..., 3]
    with np.errstate(all="ignore"):
        s = f32(1.0) / (f32(1.0) + np.exp(sdf * b))
        e = np.exp(-b * s)
        a = f32(1.0) - e
        f = (f32(1.0) - a) + f32(1e-10)
        p = np.concatenate([np.ones((R, 1), f32), f[:, :-1]], axis=1)
        k = 1
        while k < S:
            p = np.concatenate([p[:, :k], p[:, k:] * p[:, :-k]], axis=1)
            k *= 2
        T = p
        w = a * T
        rgb = np.stack([_lane_tree(w * raw[..., c]) for c in range(3)], -1)
        D = _lane_tree(w * z)
        term = _lane_tree(w)
        err = D[:, None] - z
        std = np.sqrt(_lane_tree(w * (err * err)))
        u = f32(1.0) - term
        fwd = (rgb, D, term, u * u, std)
        probe = (w, D)
        if gs is None:
            return fwd, probe, None
        g_rgb, g_depth, g_term, g_unc, g_std = gs
        zero = np.zeros(R, f32)
        gr = g_rgb if g_rgb is not None else np.zeros((R, 3), f32)
        g_t = g_term if g_term is not None else zero
        if g_unc is not None:
            g_t = g_t - (f32(2.0) * (f32(1.0) - term)) * g_unc
        g_s = g_std / (f32(2.0) * std) if g_std is not None else zero
        g_d = g_depth if g_depth is not None else zero
        if g_std is not None:
            g_d = g_d + g_s * _lane_tree(w * (f32(2.0) * err))
        gw = np.repeat(g_t[:, None], S, 1)
        if g_rgb is not None:
            gw = gw + ((gr[:, None, 0] * raw[..., 0]
                        + gr[:, None, 1] * raw[..., 1])
                       + gr[:, None, 2] * raw[..., 2])
        if g_depth is not None or g_std is not None:
            gw = gw + g_d[:, None] * z
        if g_std is not None:
            gw = gw + g_s[:, None] * (err * err)
        U, F = gw * a, f.copy()
        k = 1
        while k < S:
            U = np.concatenate([U[:, :S - k] + F[:, :S - k] * U[:, k:],
                                U[:, S - k:]], axis=1)
            F = np.concatenate([F[:, :S - k] * F[:, k:], F[:, S - k:]],
                               axis=1)
            k *= 2
        A = np.concatenate([U[:, 1:], np.zeros((R, 1), f32)], axis=1)
        da = T * (gw - A)
        gq = -da * e
        gu = (gq * -b) * (s * (f32(1.0) - s))
        d_raw = np.concatenate([gr[:, None, :] * w[..., None],
                                (gu * -b)[..., None]], -1)
        db = _lane_tree(gq * -s + gu * -sdf)
        rays = 8                                  # rays a block
        n_blocks = -(-R // rays)
        part = _block_tree(np.concatenate(
            [db, np.zeros(n_blocks * rays - R, f32)]).reshape(n_blocks, rays))
        threads = 256                             # the last block's threads
        acc = np.zeros(threads, f32)
        for i in range(0, n_blocks, threads):
            chunk = part[i:i + threads]
            acc[:chunk.size] = acc[:chunk.size] + chunk
        d_beta = _block_tree(acc)
    return fwd, probe, (d_raw, np.float32(d_beta))


@pytest.mark.parametrize("cot", sorted(COTANGENTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_warp_order_transcription_passes_the_card_check(case, cot):
    """The kernel's arithmetic order, transcribed on the CPU, passes
    `chip_smoke.k3_misfit` against the plain version (forward, probe
    weights, d_raw, d beta) and against the JAX package's compositing and
    `jax.vjp`, with NaN and inf in the same places: on every ray set
    (saturated rays' T falls below the denormals within five samples) and
    with all five cotangents or the loop's rgb and depth."""
    raw, z, beta = _case(case)
    keep = COTANGENTS[cot]
    gs = _cotangents(raw, len(keep))
    passed = [gs[i] if i in keep else None for i in range(5)]
    fwd, probe, (d_raw, d_beta) = _warp_transcription(raw, z, beta, passed)

    traw, tz = torch.tensor(raw, requires_grad=True), torch.tensor(z)
    tbeta = torch.tensor(beta, requires_grad=True)
    outs = k3.composite_plain(traw, tz, tbeta)
    p_draw, p_dbeta = torch.autograd.grad(
        [outs[i] for i in keep], (traw, tbeta),
        [torch.tensor(gs[i]) for i in keep])
    pw, pd = k3.probe_weights_plain(traw.detach()[..., 3], tz, tbeta.detach())
    j_outs = _jax_composite(jnp.asarray(raw), jnp.asarray(z), beta)
    _, vjp = jax.vjp(
        lambda r, b: [_jax_composite(r, jnp.asarray(z), b)[i] for i in keep],
        jnp.asarray(raw), jnp.float32(beta))
    j_draw, j_dbeta = vjp([jnp.asarray(gs[i]) for i in keep])

    terms = chip_smoke.k3_value_terms(traw.detach(), tz, tbeta.detach())
    g_terms = chip_smoke.k3_grad_terms(
        traw.detach(), tz, tbeta.detach(),
        [None if g is None else torch.tensor(g) for g in passed])
    t = torch.tensor
    for ref_f, ref_g in (
            ((o.detach() for o in outs), (p_draw, p_dbeta)),
            ((t(np.asarray(o)) for o in j_outs),
             (t(np.asarray(j_draw)), t(np.asarray(j_dbeta))))):
        fits = [chip_smoke.k3_misfit(t(o), r, tm, False)
                for o, r, tm in zip(fwd, ref_f, terms)]
        fits += [chip_smoke.k3_misfit(t(d_raw), ref_g[0], g_terms[0], True),
                 chip_smoke.k3_misfit(t(d_beta).reshape(()),
                                      ref_g[1].reshape(()), g_terms[1], True)]
        assert all(f["ok"] for f in fits), fits
    fits = [chip_smoke.k3_misfit(t(probe[0]), pw, pw.abs(), False),
            chip_smoke.k3_misfit(t(probe[1]), pd, (pw * tz.abs()).sum(-1),
                                 False)]
    assert all(f["ok"] for f in fits), fits
