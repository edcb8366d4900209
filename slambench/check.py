"""The output check: what the timed path produces, held to the plain
reference (`reference.py`).

After the window (and the profiled stretch) the harness drives the next
mapping frame of the stream through `UniSLAM.step_frame`, as the window
does. Before that frame it loads a checkpoint of its own into the
program, in place, as a checkpoint load would: every scene leaf drawn
from the seed on the card. At the frame's
first tracking iteration it sets the pose being optimised to one of its
own (the frame's true pose, perturbed from the seed), and at the first
mapping iteration the keyframe and current-frame poses likewise; both
optimisers are fresh there. From these starts the reference runs the
first `LOSS_ITERS` tracking iterations and mapping iterations on its own,
Adam included, on the harness's copy of the frames and on draws the
harness makes (pixels, keyframe slots, sample jitter, probe uniforms). A
ray that lies on a mask threshold within `TOL` in the reference is
redrawn before the program sees the draws. The program takes the same
draws; its loss at each of these iterations is recorded, and at the first
also every leaf's gradient and the leaves before and after its
optimiser's step.

The two sides start from the same leaves, so at the first iteration
they differ by rounding alone. After it each follows its own steps:
Adam's step divides by the gradient's running size, which turns a
rounding difference in a small moment into a difference of the step's
size, and the gradient of a hash-grid field jumps where a sample crosses
a cell, so later gradients of two sound sides can differ by a large
share while their losses agree to rounding for a few iterations and then
part too. So the gradients and the steps are compared at the first
iteration, and the loss at each of the first `LOSS_ITERS`: a fault that
builds up over the iterations moves the loss.

What the reference takes from the program are decisions, not numbers:
which frame each keyframe slot holds and which of its pixels the bank
kept (read from the bank's stored ray direction), the window's slot
distribution, and which keyframe poses bundle adjustment moves.
`bank_pixels` holds the bank's stored pixels to the frames themselves.

Numbers compared (each has a limit, `limits/<workload>.json`):
    track_loss, map_loss   |L_prog - L_ref| / |L_ref|, the worst over the
                           first LOSS_ITERS iterations
    track_grad, map_grad   worst leaf at the first iteration:
                           ||g_prog - g_ref|| over the larger of ||g_ref||
                           and the median leaf's norm
    track_step, map_step   the same for the change each side's first step
                           makes, over the leaves whose reference
                           gradient is at least 1e-3 of the median leaf's
    bank_pixels            drawn keyframe pixels whose depth or colour is
                           not the source frame's at that pixel
"""

from __future__ import annotations

import statistics
import zlib

import numpy as np
import torch

from slambench import reference

NUMBERS = ("track_loss", "track_grad", "track_step", "map_loss", "map_grad",
           "map_step", "bank_pixels")
# a ray whose margin to a mask test is under this in the reference is
# redrawn (at most REDRAWS times)
TOL = 1e-4
REDRAWS = 8
# the iterations of each kind that the reference follows: as far as two
# sound sides' losses stay within rounding of each other (a dozen seeds a
# cell read at most 8.3e-8 through the 4th iteration and up to 3e-4 by the
# 15th)
LOSS_ITERS = 3
# the harness's checkpoint: grid tables U(-TABLE_AMP, TABLE_AMP), decoders
# nn.Linear-style, beta U(9, 11); poses the truth perturbed by these. (A
# trained map is rougher, 0.7-2.5 RMS a level; from such a start two sound
# sides' losses part by up to 1e-3 within a mapping phase.)
TABLE_AMP = 0.1
QUAT_NOISE, TRANS_NOISE_M = 0.003, 0.01
TRACK_BETAS, MAP_BETAS = (0.5, 0.999), (0.9, 0.999)
_MASK63 = (1 << 63) - 1


def _seed(*parts) -> int:
    """A generator seed from the run seed and the iteration's place."""
    rng = np.random.default_rng([int(p) & (2 ** 64 - 1) for p in parts])
    return int(rng.integers(0, _MASK63))


def _gen(device, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(_seed(*parts))
    return g


def flat_scene(scene) -> dict:
    """{"sdf_table", "color_table", "beta", "sdf_mlp.w0", ...}."""
    out = {}
    for k, v in scene.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": t for n, t in v.items()})
        else:
            out[k] = v
    return out


def _clone(leaves: dict) -> dict:
    return {k: v.detach().clone() for k, v in leaves.items()}


# -- the harness's starting state ----------------------------------------

def checkpoint(leaves: dict, seed: int, frame: int) -> dict:
    """Scene leaves drawn from the seed at the shapes of `leaves` (flat),
    on their device: the harness's own copy."""
    out = {}
    for name, t in leaves.items():
        g = _gen(t.device, seed, frame, 0, zlib.crc32(name.encode()))
        u = torch.rand(t.shape, generator=g, device=t.device)
        if name == "beta":
            out[name] = 9.0 + 2.0 * u
        elif name.endswith("table"):
            out[name] = (2.0 * u - 1.0) * TABLE_AMP
        else:
            head, _, leaf = name.partition(".")
            fan_in = leaves[f"{head}.w{leaf[1:]}"].shape[0]
            out[name] = (2.0 * u - 1.0) / fan_in ** 0.5
    return out


def load_checkpoint(slam, state: dict) -> None:
    """Copy the harness's leaves into the program's scene in place."""
    with torch.no_grad():
        for k, t in flat_scene(slam.params).items():
            t.copy_(state[k])


def noisy_pose(c2w, g: torch.Generator, device) -> torch.Tensor:
    """(7,) [quaternion, translation] of the c2w matrix (4, 4), perturbed
    by draws from `g`."""
    m = torch.as_tensor(np.asarray(c2w, np.float64), device=device)
    q = reference.matrix_to_quat(m[:3, :3]).to(torch.float32)
    q = q + QUAT_NOISE * torch.randn(4, generator=g, device=device)
    t = m[:3, 3].to(torch.float32) \
        + TRANS_NOISE_M * torch.randn(3, generator=g, device=device)
    return torch.cat([q / torch.linalg.norm(q), t])


# -- the reference following the program ---------------------------------

def _adam_all(params: dict, grads: dict, state: dict, lrs: dict,
              betas) -> tuple:
    new, st = {}, {}
    for k in params:
        new[k], st[k] = reference.adam(params[k], grads[k], state.get(k, {}),
                                       lrs[k], betas)
    return new, st


def _redraw(draws: dict, bad: torch.Tensor, fresh: dict) -> dict:
    """`draws` with the rows of rays `bad` taken from `fresh`."""
    return {k: torch.where(bad.reshape((-1,) + (1,) * (v.dim() - 1)),
                           fresh[k], v) for k, v in draws.items()}


def follow(step, start: dict, n: int, draw, lrs: dict, betas,
           tf32: bool = False, draws=None) -> dict:
    """The reference through iterations 0 .. n-1 from the leaves `start`:
    at iteration i, `step(leaves, draws, tf32)` -> {"loss", "grad",
    "margins"}, then Adam. `draws` given (a list), or `draw(i, r)` makes
    iteration i's (r = 0) and replaces the rays whose margin is under TOL
    (r = 1 ..). Returns {"draws", "losses" (each iteration's), "first"
    (iteration 0's loss, grad, before, after), "border" (rays still on a
    threshold)}."""
    given = draws is not None
    draws = list(draws) if given else []
    leaves, state, losses, border, first = dict(start), {}, [], 0, None
    for i in range(n):
        d = draws[i] if given else draw(i, 0)
        res = step(leaves, d, tf32)
        r = 0
        while not given and r < REDRAWS:
            bad = res["margins"] < TOL
            if not bool(bad.any()):
                break
            r += 1
            d = _redraw(d, bad, draw(i, r))
            res = step(leaves, d, tf32)
        if not given:
            border += int((res["margins"] < TOL).sum())
            draws.append(d)
        after, state = _adam_all(leaves, res["grad"], state, lrs, betas)
        losses.append(res["loss"])
        if i == 0:
            first = {"loss": res["loss"], "grad": res["grad"],
                     "before": leaves, "after": after}
        leaves = after
    return {"draws": draws, "losses": losses, "first": first,
            "border": border}


def dir_pixel(dirs: np.ndarray, intr: dict) -> tuple:
    """(row, column) of the pixels whose camera directions (N, 3) these
    are, rounded to the nearest."""
    col = np.rint(dirs[:, 0] * intr["fx"] + intr["cx"]).astype(np.int64)
    row = np.rint(intr["cy"] - dirs[:, 1] * intr["fy"]).astype(np.int64)
    return row, col


class MapInputs:
    """A mapping iteration's per-ray inputs from the harness's frames: the
    current frame's pixels, and for a keyframe slot the pixel of its
    source frame that the bank keeps at that place."""

    def __init__(self, stream, frame: int, bank, max_kf: int, intr: dict,
                 device):
        self.stream, self.frame, self.bank = stream, frame, bank
        self.max_kf, self.intr, self.device = max_kf, intr, device
        self.frame_idx = bank.frame_idx.cpu().numpy()

    def pixels(self, d: dict):
        """(source frame, row, column) of every ray, numpy."""
        W, H, intr = self.intr["W"], self.intr["H"], self.intr
        cur = (d["slot"] == self.max_kf).cpu().numpy()
        kf = d["slot"].clamp(max=self.max_kf - 1)
        row_b, col_b = dir_pixel(
            self.bank.rays_d[kf, d["pix_b"]].cpu().numpy(), intr)
        pc = d["pix_c"].cpu().numpy()
        col = np.where(cur, pc % W, col_b)
        row = np.where(cur, pc // W, row_b)
        src = np.where(cur, self.frame, self.frame_idx[kf.cpu().numpy()])
        return (src, np.clip(row, 0, H - 1).astype(np.int64),
                np.clip(col, 0, W - 1).astype(np.int64))

    def __call__(self, d: dict) -> dict:
        src, row, col = self.pixels(d)
        k = self.stream.pool_index(np.maximum(src, 0))
        dev = self.device
        i = torch.as_tensor(col, device=dev)
        j = torch.as_tensor(row, device=dev)
        return {"depth": torch.as_tensor(self.stream.depth[k, row, col],
                                         device=dev),
                "color": torch.as_tensor(self.stream.color[k, row, col],
                                         device=dev),
                "dir": reference.pixel_dirs(i, j, self.intr)}


def ref_sizes(cfg: dict, shp: dict) -> dict:
    r = cfg["rendering"]
    return {"intr": shp["intr"], "bound": shp["bound"], "grids": shp["grids"],
            "truncation": float(cfg["model"]["truncation"]),
            "n_strat": r["n_stratified"], "n_imp": r["n_importance"],
            "learnable_beta": bool(r.get("learnable_beta", True)),
            "beta_init": 10.0}


def map_lrs(cfg: dict, names) -> dict:
    m = cfg["mapping"]
    scale = float(m.get("lr_factor", 1.0))
    lr = m["lr"]
    out = {}
    for k in names:
        if k == "sdf_table":
            out[k] = lr["hash_grids_lr"] * scale
        elif k == "color_table":
            out[k] = lr["c_hash_grids_lr"] * scale
        elif k == "poses":
            out[k] = m.get("joint_opt_cam_lr", 0.001)
        else:
            out[k] = lr["decoders_lr"] * scale
    return out


class Capture:
    """The check frame: installed on the program's tracker and mapper
    instances (and removed after the frame), it sets the starting poses,
    runs the reference ahead of the program's first LOSS_ITERS iterations
    of each kind, hands the program their draws and records its outputs
    (the later iterations run on the program's own draws)."""

    def __init__(self, slam, stream, cfg: dict, shp: dict, seed: int,
                 frame: int):
        self.slam, self.stream, self.cfg = slam, stream, cfg
        self.seed, self.frame, self.dev = seed, frame, slam.device
        self.sz = ref_sizes(cfg, shp)
        self.n = {"track": min(LOSS_ITERS, slam.tc.iters),
                  "map": min(LOSS_ITERS, slam.mc.iters)}
        self.scene = checkpoint(flat_scene(slam.params), seed, frame)
        load_checkpoint(slam, self.scene)
        # the program's outputs {"losses", "first"}, and the reference's
        # plans: follow()'s record with "start" (and "inputs", "mask", ...)
        self.prog = {"track": {"losses": []}, "map": {"losses": []}}
        self.plan = {}
        self._t = self._m = 0
        self._orig = (slam.tracker.step, slam.mapper.step)

    def __enter__(self):
        self.slam.tracker.step = self._track_step
        self.slam.mapper.step = self._map_step
        return self

    def __exit__(self, *exc):
        del self.slam.tracker.step, self.slam.mapper.step

    def _record(self, kind: str, it: int, loss, leaves: dict, before):
        rec = self.prog[kind]
        rec["losses"].append(loss.detach().clone())
        if it == 0:
            rec["first"] = {
                "loss": loss.detach().clone(),
                "grad": {k: (torch.zeros_like(v) if v.grad is None
                             else v.grad.detach().clone())
                         for k, v in leaves.items()},
                "before": before, "after": _clone(leaves)}

    # -- tracking --
    def track_step(self, leaves, d, tf32):
        return reference.tracking_step(self.sz, self.cfg["tracking"],
                                       self.scene, leaves, self.frame_data,
                                       d, tf32)

    def track_draw(self, i: int, r: int) -> dict:
        tc, intr, dev = self.slam.tc, self.sz["intr"], self.dev
        g = _gen(dev, self.seed, self.frame, 1, i, r)
        S = self.sz["n_strat"] + self.sz["n_imp"]
        return {"j": torch.randint(tc.ignore_edge_H, intr["H"]
                                   - tc.ignore_edge_H, (tc.pixels,),
                                   generator=g, device=dev),
                "i": torch.randint(tc.ignore_edge_W, intr["W"]
                                   - tc.ignore_edge_W, (tc.pixels,),
                                   generator=g, device=dev),
                "t_depth": torch.rand(tc.pixels, S, generator=g, device=dev)}

    def track_lrs(self) -> dict:
        tc = self.cfg["tracking"]
        return {"R": tc["lr_R"], "T": tc["lr_T"]}

    def _plan_tracking(self, pose) -> None:
        _, _, gt = self.stream[self.frame]
        p7 = noisy_pose(gt, _gen(self.dev, self.seed, self.frame, 3),
                        self.dev)
        with torch.no_grad():
            pose["R"].copy_(p7[:4])
            pose["T"].copy_(p7[4:])
        start = {"R": p7[:4], "T": p7[4:]}
        self.plan["track"] = {
            **follow(self.track_step, start, self.n["track"],
                     self.track_draw, self.track_lrs(), TRACK_BETAS),
            "start": start}

    def _track_step(self, params, pose, opt, depth_img, color_img,
                    generator=None, draws=None):
        it, self._t = self._t, self._t + 1
        if it == 0:
            self._plan_tracking(pose)
        if it >= self.n["track"]:
            return self._orig[0](params, pose, opt, depth_img, color_img,
                                 generator, draws)
        before = _clone(pose) if it == 0 else None
        loss, unc = self._orig[0](params, pose, opt, depth_img, color_img,
                                  generator, self.plan["track"]["draws"][it])
        self._record("track", it, loss, pose, before)
        return loss, unc

    # -- mapping --
    def map_step(self, leaves, d, tf32):
        scene = {k: v for k, v in leaves.items() if k != "poses"}
        p = self.plan["map"]
        return reference.mapping_step(self.sz, self.cfg["mapping"], scene,
                                      leaves["poses"], p["mask"],
                                      p["inputs"](d), d, tf32)

    def map_draw(self, i: int, r: int) -> dict:
        mc, dev, p = self.slam.mc, self.dev, self.plan["map"]
        g = _gen(dev, self.seed, self.frame, 2, i, r)
        n = mc.pixels + mc.extra_rays
        return {"slot": torch.cat([
                    torch.multinomial(p["sel_probs"], mc.pixels, True,
                                      generator=g),
                    torch.multinomial(p["extra_probs"], mc.extra_rays, True,
                                      generator=g)]),
                "pix_b": torch.randint(0, self.slam.bank_size, (n,),
                                       generator=g, device=dev),
                "pix_c": torch.randint(0, self.sz["intr"]["H"]
                                       * self.sz["intr"]["W"], (n,),
                                       generator=g, device=dev),
                "t_depth": torch.rand(n, self.sz["n_strat"]
                                      + self.sz["n_imp"], generator=g,
                                      device=dev),
                "t_uni": torch.rand(n, self.sz["n_strat"], generator=g,
                                    device=dev),
                "u_pdf": torch.rand(n, self.sz["n_imp"], generator=g,
                                    device=dev)}

    def _plan_mapping(self, poses, batch) -> None:
        g = _gen(self.dev, self.seed, self.frame, 4)
        rows = []
        for f in batch.bank.frame_idx.cpu().numpy().tolist() + [self.frame]:
            c2w = self.stream[f][2] if f >= 0 else np.eye(4)
            rows.append(noisy_pose(c2w, g, self.dev))
        p7 = torch.stack(rows)
        with torch.no_grad():
            poses.copy_(p7)
        start = {**self.scene, "poses": p7}
        self.plan["map"] = p = {
            "mask": batch.pose_grad_mask.clone(),
            "sel_probs": batch.sel_probs.clone(),
            "extra_probs": batch.extra_probs.clone(),
            "inputs": MapInputs(self.stream, self.frame, batch.bank,
                                self.slam.max_kf, self.sz["intr"], self.dev),
            "start": start, "lrs": map_lrs(self.cfg, start)}
        p.update(follow(self.map_step, start, self.n["map"], self.map_draw,
                        p["lrs"], MAP_BETAS))

    def _map_step(self, scene, poses, opt, batch, generator=None,
                  draws=None):
        it, self._m = self._m, self._m + 1
        if it == 0:
            self._plan_mapping(poses, batch)
        if it >= self.n["map"]:
            return self._orig[1](scene, poses, opt, batch, generator, draws)
        leaves = {**flat_scene(scene), "poses": poses}
        d = self.plan["map"]["draws"][it]
        before = _clone(leaves) if it == 0 else None
        loss = self._orig[1](scene, poses, opt, batch, generator, d)
        self._record("map", it, loss, leaves, before)
        self.prog["map"].setdefault("bank", []).append(
            self._bank_pixels(batch.bank, d))
        return loss

    def _bank_pixels(self, bank, d) -> dict:
        kf = d["slot"].clamp(max=self.slam.max_kf - 1)
        return {"slot": d["slot"].clone(),
                "depth": bank.depth[kf, d["pix_b"]].clone(),
                "color": bank.color[kf, d["pix_b"]].clone(),
                "dir": bank.rays_d[kf, d["pix_b"]].clone()}

    # -- the control: the reference in TF32 on the same draws --
    def control(self) -> dict:
        """follow()'s records of the reference computed with TF32
        products, from the same starts on the same draws."""
        out = {}
        if "track" in self.plan:
            t = self.plan["track"]
            out["track"] = follow(self.track_step, t["start"],
                                  self.n["track"], None, self.track_lrs(),
                                  TRACK_BETAS, tf32=True, draws=t["draws"])
        if "map" in self.plan:
            m = self.plan["map"]
            out["map"] = follow(self.map_step, m["start"], self.n["map"],
                                None, m["lrs"], MAP_BETAS, tf32=True,
                                draws=m["draws"])
        return out

    def program(self) -> dict:
        return self.prog

    def borderline(self) -> int:
        """Rays still on a mask threshold after the redraws."""
        return sum(p["border"] for p in self.plan.values())

    @property
    def frame_data(self):
        if not hasattr(self, "_frame_data"):
            c, d, _ = self.stream[self.frame]
            self._frame_data = (
                torch.as_tensor(np.array(d), device=self.dev),
                torch.as_tensor(np.array(c), device=self.dev))
        return self._frame_data


def bank_mismatch(cap: Capture) -> int:
    """Drawn bank pixels whose depth or colour differs from the source
    frame's at the pixel their stored camera direction names (or whose
    slot holds no frame, or whose direction names no pixel)."""
    if "map" not in cap.plan:
        return 0
    inputs, intr, stream = cap.plan["map"]["inputs"], cap.sz["intr"], \
        cap.stream
    max_kf, bad = cap.slam.max_kf, 0
    for b in cap.prog["map"].get("bank", []):
        in_bank = (b["slot"] < max_kf).cpu().numpy()
        src = inputs.frame_idx[b["slot"].clamp(max=max_kf - 1).cpu().numpy()]
        row, col = dir_pixel(b["dir"].cpu().numpy(), intr)
        wrong = (src < 0) | (col < 0) | (col >= intr["W"]) | (row < 0) \
            | (row >= intr["H"])
        ok = ~wrong & in_bank
        k = stream.pool_index(src[ok])
        depth = b["depth"].cpu().numpy()[ok]
        color = b["color"].cpu().numpy()[ok]
        wrong[ok] = (stream.depth[k, row[ok], col[ok]] != depth) | np.any(
            stream.color[k, row[ok], col[ok]] != color, axis=-1)
        bad += int((wrong & in_bank).sum())
    return bad


def _max(a: float, b: float) -> float:
    """The larger, NaN winning (a NaN reading must fail its limit)."""
    return a if a != a or a >= b else b


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _worst(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of ||p - r|| / max(||r||, the median leaf's norm)."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double()))
             for k in ref}
    floor = statistics.median(norms.values())
    worst = 0.0
    for k in ref:
        if keep is not None and k not in keep:
            continue
        gap = float(torch.linalg.vector_norm((prog[k] - ref[k]).double()))
        worst = _max(worst, gap / max(norms[k], floor, 1e-30))
    return worst


def _moved(grads: dict) -> set:
    """Leaves whose reference gradient is at least 1e-3 of the median
    leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(g.double()))
             for k, g in grads.items()}
    floor = 1e-3 * statistics.median(norms.values())
    return {k for k, n in norms.items() if n >= floor and n > 0}


def _step(rec: dict) -> dict:
    return {k: rec["after"][k] - rec["before"][k] for k in rec["before"]}


def numbers(judged: dict, cap: Capture) -> dict:
    """Each compared number; `judged`: {"track": ..., "map": ...} with
    "losses" and "first" (the program's or the control's). What the judged
    side did not produce reads NaN."""
    out = {k: 0.0 for k in NUMBERS}
    nan = float("nan")
    for kind in ("track", "map"):
        ref, got = cap.plan.get(kind), judged.get(kind, {})
        losses = got.get("losses", [])
        if ref is None or len(losses) < cap.n[kind] \
                or got.get("first") is None:
            out.update({f"{kind}_{n}": nan for n in ("loss", "grad",
                                                     "step")})
            continue
        for a, b in zip(losses, ref["losses"]):
            out[f"{kind}_loss"] = _max(out[f"{kind}_loss"], _rel(a, b))
        first, rf = got["first"], ref["first"]
        out[f"{kind}_grad"] = _worst(first["grad"], rf["grad"])
        out[f"{kind}_step"] = _worst(_step(first), _step(rf),
                                     _moved(rf["grad"]))
    out["bank_pixels"] = float(bank_mismatch(cap))
    return out


def loss_gaps(judged: dict, cap: Capture) -> dict:
    """Each iteration's relative loss gap, for the calibration's records."""
    return {kind: [_rel(a, b) for a, b in zip(
        judged.get(kind, {}).get("losses", []), cap.plan[kind]["losses"])]
        for kind in ("track", "map") if kind in cap.plan}


def judge(nums: dict, limits: dict) -> bool:
    """Every number at or under its limit (and a number, not NaN)."""
    return all(nums[k] <= limits[k] for k in NUMBERS)
