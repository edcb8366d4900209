"""The plain reference of one tracking and one mapping iteration of the
hash-grid Uni-SLAM loop, in f32 PyTorch with autograd.

Written from the published method (the reference implementation's
`Tracker`, `Mapper`, `render_batch_ray`, hash grids of instant-ngp) and
imports nothing of the program under test: the multiresolution hash
encoding, the decoders, depth-guided and probe sampling, SDF compositing,
the masked SDF / colour / depth losses and Adam are all written out here.
Gradients come from autograd. Matrix products run in f32 with TF32 off
(`mm`), or, for the control, with their operands rounded to TF32
(`tf32=True`): the next precision below the configuration's.

Inputs are plain tensors: the scene leaves and poses the iteration starts
from, the frame pixels and the random draws, all handed in by the harness.
Each iteration also gives every ray's margin to its mask tests, so that
the harness can redraw a ray that lies on a threshold to rounding.
"""

from __future__ import annotations

import itertools

import torch

PRIMES = (1, 2654435761, 805459861)


# -- matrix products ---------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with every product's operands rounded to TF32, forward and
    backward, f32 sums: what a TF32 tensor-core product computes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32(a) @ _tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return g @ _tf32(b).T, _tf32(a).T @ g


def mm(a, b, tf32: bool = False):
    return _TF32MatMul.apply(a, b) if tf32 else a @ b


# -- pose and rays -----------------------------------------------------

def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) [w, x, y, z], normalised here -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def pixel_dirs(i, j, intr) -> torch.Tensor:
    """Camera-frame directions of pixels (column i, row j), OpenGL."""
    i, j = i.to(torch.float32), j.to(torch.float32)
    return torch.stack([(i - intr["cx"]) / intr["fx"],
                        -(j - intr["cy"]) / intr["fy"], -torch.ones_like(i)],
                       dim=-1)


def to_world(dirs, rot, trans):
    """Rotate directions (N, 3) by rot (N, 3, 3) or (3, 3); origins."""
    d = torch.sum(rot * dirs[..., None, :], dim=-1)
    return trans.expand(d.shape), d


def far_exit(o, d, bound) -> torch.Tensor:
    """Distance along each ray to where it leaves the box (3, 2)."""
    t = (bound[None] - o[..., None]) / d[..., None]
    return t.amax(-1).amin(-1)


# -- the scene -----------------------------------------------------------

def hash_encode(table, p, g) -> torch.Tensor:
    """Trilinear interpolation of a multiresolution hash grid at points p
    (N, 3) (clamped to [0, 1]): (N, L*F), level-major. `g`: the grid's
    levels (slambench.shapes.hash_grid)."""
    p = p.clamp(0.0, 1.0)
    dev = p.device
    out = []
    for lv in range(g["L"]):
        pos = p * float(g["scales"][lv]) + 0.5
        base = torch.floor(pos)
        frac = pos - base
        base = base.to(torch.int64)
        res, size = int(g["res"][lv]), int(g["sizes"][lv])
        feat = 0.0
        for corner in itertools.product((0, 1), repeat=3):
            c = torch.minimum((base + torch.tensor(corner, device=dev))
                              .clamp(min=0), torch.tensor(res - 1,
                                                          device=dev))
            if g["hashed"][lv]:
                idx = ((c[:, 0] * PRIMES[0]) & g["mask"]) ^ \
                    ((c[:, 1] * PRIMES[1]) & g["mask"]) ^ \
                    ((c[:, 2] * PRIMES[2]) & g["mask"])
            else:
                idx = c[:, 0] + c[:, 1] * res + c[:, 2] * res * res
            idx = idx.clamp(max=size - 1) + int(g["offsets"][lv])
            w = [frac[:, a] if corner[a] else 1.0 - frac[:, a]
                 for a in range(3)]
            feat = feat + (w[0] * w[1] * w[2])[:, None] * table[idx]
        out.append(feat)
    return torch.cat(out, dim=-1)


def mlp(params, x, tf32: bool) -> torch.Tensor:
    """ReLU MLP {w0, b0, w1, b1, ...}, weights (d_in, d_out)."""
    n = len(params) // 2
    for k in range(n):
        x = mm(x, params[f"w{k}"], tf32) + params[f"b{k}"]
        if k < n - 1:
            x = torch.relu(x)
    return x


def query(scene, grids, p, tf32: bool) -> torch.Tensor:
    """(N, 4) [r, g, b, sdf] at normalised points."""
    sdf = torch.tanh(mlp(scene["sdf_mlp"], hash_encode(
        scene["sdf_table"], p, grids["sdf"]), tf32))
    rgb = torch.sigmoid(mlp(scene["color_mlp"], hash_encode(
        scene["color_table"], p, grids["color"]), tf32))
    return torch.cat([rgb, sdf], dim=-1)


def query_sdf(scene, grids, p, tf32: bool) -> torch.Tensor:
    return torch.tanh(mlp(scene["sdf_mlp"], hash_encode(
        scene["sdf_table"], p, grids["sdf"]), tf32))[:, 0]


# -- rendering -------------------------------------------------------------

class _Cumprod(torch.autograd.Function):
    """Inclusive product over the last axis, backward without division
    (a factor can be 1e-10)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        S = x.shape[-1]
        grads = [None] * S
        acc = g[..., S - 1]
        for j in range(S - 1, 0, -1):
            grads[j] = out[..., j - 1] * acc
            acc = g[..., j - 1] + x[..., j] * acc
        grads[0] = acc
        return torch.stack(grads, dim=-1)


def weights(sdf, beta) -> torch.Tensor:
    """w_i = alpha_i prod_{j<i} (1 - alpha_j + 1e-10), with
    alpha = 1 - exp(-beta sigmoid(-beta sdf))."""
    alpha = 1.0 - torch.exp(-beta * torch.sigmoid(-sdf * beta))
    trans = torch.cat([torch.ones_like(alpha[..., :1]),
                       1.0 - alpha[..., :-1] + 1e-10], dim=-1)
    return alpha * _Cumprod.apply(trans)


def stratify(z, t):
    """Jitter sorted z within their mid-point intervals by uniforms t."""
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mids], dim=-1)
    return lower + (upper - lower) * t


def z_depth(gt, trunc, n_strat, n_imp, t):
    """n_imp samples over gt +- 1.5 trunc and n_strat over [0, 1.2 gt],
    sorted, jittered."""
    dev = gt.device
    t_u = torch.linspace(0.0, 1.0, n_strat, device=dev)
    t_s = torch.linspace(0.0, 1.0, n_imp, device=dev)
    g = gt[:, None]
    z = torch.cat([1.2 * g * t_u[None], g - 1.5 * trunc
                   + 3.0 * trunc * t_s[None]], dim=-1)
    return stratify(torch.sort(z, dim=-1).values, t)


def sample_pdf(bins, w, u):
    """Inverse-CDF samples at uniforms u from the unnormalised
    cumulative sum of w over bins (the published sampler's quirk)."""
    cdf = torch.cumsum(w, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    nb = bins.shape[-1] - 1
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0 = torch.gather(bins, -1, below.clamp(max=nb))
    b1 = torch.gather(bins, -1, above.clamp(max=nb))
    den = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / den * (b1 - b0)


def z_probe(scene, grids, o, d, box, norm, n_strat, beta, t_uni, u_pdf,
            tf32):
    """Samples of rays without depth: uniform to the box exit (+1 cm),
    plus inverse-CDF samples from a gradient-free SDF query there."""
    with torch.no_grad():
        far = far_exit(o, d, box)
        t = torch.linspace(0.0, 1.0, n_strat, device=o.device)
        z_u = stratify((far[:, None] + 0.01) * t[None], t_uni)
        pts = (o[:, None] + d[:, None] * z_u[..., None]).reshape(-1, 3)
        sdf = query_sdf(scene, grids, norm(pts), tf32).reshape(z_u.shape)
        w = weights(sdf, beta)
        mids = 0.5 * (z_u[..., 1:] + z_u[..., :-1])
        z_s = sample_pdf(mids, w[..., 1:-1], u_pdf)
        return torch.sort(torch.cat([z_u, z_s], dim=-1), dim=-1).values


def render(scene, sz, o, d, gt, draws, probe: bool, tf32: bool) -> dict:
    """Render rays with sensor depth gt (0: none)."""
    beta = scene["beta"][0] if sz["learnable_beta"] else torch.tensor(
        sz["beta_init"], device=o.device)
    lo = torch.as_tensor(sz["bound"][:, 0], device=o.device)
    ext = torch.as_tensor(sz["bound"][:, 1] - sz["bound"][:, 0],
                          device=o.device)

    def norm(pts):
        return (pts - lo) / ext

    z = z_depth(gt.clamp(min=1e-6), sz["truncation"], sz["n_strat"],
                sz["n_imp"], draws["t_depth"])
    if probe:
        zp = z_probe(scene, sz["grids"], o.detach(), d.detach(),
                     torch.as_tensor(sz["bound"], device=o.device), norm,
                     sz["n_strat"], beta, draws["t_uni"], draws["u_pdf"],
                     tf32)
        z = torch.where((gt > 0)[:, None], z, zp)
    R, S = z.shape
    pts = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    raw = query(scene, sz["grids"], norm(pts), tf32).reshape(R, S, 4)
    w = weights(raw[..., 3], beta)
    term = w.sum(-1)
    return {"rgb": torch.sum(w[..., None] * raw[..., :3], dim=-2),
            "depth": torch.sum(w * z, dim=-1), "unc": (1.0 - term) ** 2,
            "sdf": raw[..., 3], "z": z}


# -- losses --------------------------------------------------------------

def mmean(x, m):
    m = m.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(m.sum(), min=1.0)


def sdf_loss(sdf, z, gt, ray_m, trunc, w):
    g = gt[:, None]
    rm = ray_m[:, None]
    front = (z < g - trunc) & rm
    back = (z > g + trunc) & rm
    center = (z > g - 0.4 * trunc) & (z < g + 0.4 * trunc) & rm
    tail = ~front & ~back & ~center & rm
    est = z + sdf * trunc
    return (w[0] * mmean((sdf - 1.0) ** 2, front)
            + w[1] * mmean((est - g) ** 2, center)
            + w[2] * mmean((est - g) ** 2, tail))


def median(x, m):
    """The lower middle value of x over m."""
    vals = torch.sort(torch.where(m, x, torch.full_like(
        x, torch.finfo(x.dtype).max))).values
    k = int(m.sum())
    return vals[max(k - 1, 0) // 2]


def tracking_loss(out, gt, gt_color, inside, lw, trunc):
    """The tracker's loss."""
    err = (gt - out["depth"].detach()).abs()
    alpha_ok = (1.0 - out["unc"].detach()) > 0.99
    near = err < 10.0 * median(err, inside)
    m = alpha_ok & near & inside
    return (sdf_loss(out["sdf"], out["z"], gt, m, trunc, lw["sdf"])
            + lw["color"] * mmean((gt_color - out["rgb"]) ** 2,
                                  m[:, None].expand(-1, 3))
            + lw["depth"] * mmean((gt - out["depth"]) ** 2, m))


def tracking_margins(out, gt, inside):
    """Per ray, how far from its threshold each mask test of
    `tracking_loss` is, relative to the threshold's scale."""
    err = (gt - out["depth"].detach()).abs()
    cut = 10.0 * median(err, inside)
    a = ((1.0 - out["unc"].detach()) - 0.99).abs()
    e = (err - cut).abs() / torch.clamp(cut, min=1e-12)
    return torch.where(inside, torch.minimum(a, e), torch.full_like(a, 1.0))


def mapping_loss(out, gt, gt_color, inside, lw, trunc):
    alpha_ok = (1.0 - out["unc"].detach()) > 0.99
    m = (gt > 0) & alpha_ok & inside
    return (sdf_loss(out["sdf"], out["z"], gt, m, trunc, lw["sdf"])
            + lw["color"] * mmean((gt_color - out["rgb"]) ** 2,
                                  inside[:, None].expand(-1, 3))
            + lw["depth"] * mmean((gt - out["depth"]) ** 2, m))


def mapping_margins(out, gt, inside):
    a = ((1.0 - out["unc"].detach()) - 0.99).abs()
    return torch.where((gt > 0) & inside, a, torch.full_like(a, 1.0))


# -- Adam ----------------------------------------------------------------

def adam(p, g, state, lr, betas, eps=1e-8):
    """One Adam step from `state` ({"step", "exp_avg", "exp_avg_sq"}, or
    empty for a fresh optimiser): the new parameter and state. The
    moments and the
    update in the operation order of `torch.optim.Adam`'s own (lerp for
    the first moment; sqrt(v) / sqrt(1 - b2^t) + eps), so that rounding
    in the step itself does not enter the comparison."""
    b1, b2 = betas
    t = int(state.get("step", 0)) + 1
    m = torch.lerp(state.get("exp_avg", torch.zeros_like(p)), g, 1 - b1)
    v = state.get("exp_avg_sq", torch.zeros_like(p)) * b2 \
        + (1 - b2) * (g * g)
    denom = torch.sqrt(v) / (1 - b2 ** t) ** 0.5 + eps
    return (p + (-lr / (1 - b1 ** t)) * (m / denom),
            {"step": t, "exp_avg": m, "exp_avg_sq": v})


# -- the two iterations --------------------------------------------------

def tree(flat: dict) -> dict:
    """{"sdf_mlp.w0": t, ...} -> {"sdf_mlp": {"w0": t}, ...}."""
    out = {}
    for k, v in flat.items():
        head, _, leaf = k.partition(".")
        if leaf:
            out.setdefault(head, {})[leaf] = v
        else:
            out[k] = v
    return out


def tracking_step(sz, tc, scene, pose, frame, draws, tf32=False) -> dict:
    """One tracking iteration's loss and pose gradient at pose {"R", "T"}
    against the frozen scene (flat leaves, as `tree` takes them), and
    each ray's margin to its mask tests.
    `frame`: (depth (H, W), color (H, W, 3)); draws: i, j, t_depth."""
    depth, color = frame
    i, j = draws["i"], draws["j"]
    gt, gt_color = depth[j, i], color[j, i]
    R = pose["R"].detach().clone().requires_grad_(True)
    T = pose["T"].detach().clone().requires_grad_(True)
    o, d = to_world(pixel_dirs(i, j, sz["intr"]), quat_to_matrix(R), T)
    inside = (far_exit(o.detach(), d.detach(), torch.as_tensor(
        sz["bound"], device=o.device)) >= gt) & (gt > 0)
    rd = torch.where(gt > 0, gt, torch.ones_like(gt))
    out = render(tree(scene), sz, o, d, rd, draws, False, tf32)
    lw = {"sdf": (tc["w_sdf_fs"], tc["w_sdf_center"], tc["w_sdf_tail"]),
          "color": tc["w_color"], "depth": tc["w_depth"]}
    loss = tracking_loss(out, gt, gt_color, inside, lw, sz["truncation"])
    gR, gT = torch.autograd.grad(loss, [R, T])
    return {"loss": loss.detach(), "grad": {"R": gR, "T": gT},
            "margins": tracking_margins(out, gt, inside)}


def mapping_step(sz, mc, scene, poses, mask, batch, draws,
                 tf32=False) -> dict:
    """One mapping iteration's loss and every leaf's gradient, from scene
    leaves and keyframe poses (max_kf + 1, 7; the last the current
    frame's), BA gated by `mask` (max_kf + 1, 1), and each ray's margin to
    its mask test. `batch`: per ray gt depth, colour and camera direction;
    rays without depth take the no-depth probe."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in scene.items()}
    P = poses.detach().clone().requires_grad_(True)
    gated = P * mask + P.detach() * (1.0 - mask)
    slot = draws["slot"]
    rot = quat_to_matrix(gated[:, :4])[slot]
    o, d = to_world(batch["dir"], rot, gated[slot, 4:])
    gt, gt_color = batch["depth"], batch["color"]
    inside = far_exit(o.detach(), d.detach(), torch.as_tensor(
        sz["bound"], device=o.device)) >= gt
    probe = bool((gt <= 0).any())
    out = render(tree(leaves), sz, o, d, gt, draws, probe, tf32)
    lw = {"sdf": (mc["w_sdf_fs"], mc["w_sdf_center"], mc["w_sdf_tail"]),
          "color": mc["w_color"], "depth": mc["w_depth"]}
    loss = mapping_loss(out, gt, gt_color, inside, lw, sz["truncation"])
    names = list(leaves) + ["poses"]
    grads = torch.autograd.grad(loss, list(leaves.values()) + [P],
                                allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for k, v, g in zip(names, list(leaves.values()) + [P], grads)}
    return {"loss": loss.detach(), "grad": grads,
            "margins": mapping_margins(out, gt, inside)}


def matrix_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """(3, 3) rotation -> (4,) unit quaternion [w, x, y, z], w >= 0."""
    m = rot.to(torch.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    cands = torch.stack([1 + tr, 1 + m[0, 0] - m[1, 1] - m[2, 2],
                         1 - m[0, 0] + m[1, 1] - m[2, 2],
                         1 - m[0, 0] - m[1, 1] + m[2, 2]])
    k = int(torch.argmax(cands))
    r = torch.sqrt(cands[k].clamp(min=1e-12)) / 2
    if k == 0:
        q = [r, (m[2, 1] - m[1, 2]) / (4 * r), (m[0, 2] - m[2, 0]) / (4 * r),
             (m[1, 0] - m[0, 1]) / (4 * r)]
    elif k == 1:
        q = [(m[2, 1] - m[1, 2]) / (4 * r), r, (m[0, 1] + m[1, 0]) / (4 * r),
             (m[0, 2] + m[2, 0]) / (4 * r)]
    elif k == 2:
        q = [(m[0, 2] - m[2, 0]) / (4 * r), (m[0, 1] + m[1, 0]) / (4 * r), r,
             (m[1, 2] + m[2, 1]) / (4 * r)]
    else:
        q = [(m[1, 0] - m[0, 1]) / (4 * r), (m[0, 2] + m[2, 0]) / (4 * r),
             (m[1, 2] + m[2, 1]) / (4 * r), r]
    q = torch.stack(q)
    return q if q[0] >= 0 else -q
