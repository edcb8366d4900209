#!/usr/bin/env python3
"""Time the fixed-point scatter-accumulate kernel (K9) of one checkout of
the PyTorch port on the card, at the mapping backward's shapes of both
SLAM drives of `chip_smoke.py`:

    python3 scripts/k9_timing.py [--tree DIR] [--reps 5]

`--tree` is the root of the checkout whose `unislam_tpu_torch` (and its
kernels, built into that tree's build/) is timed; the default is this
checkout. The rows are those `chip_smoke.py` makes: K2's table rows of
both hash grids (rows of 2) and K6's rows of the brick map pair (rows of
8), from frame 0 of the room0-scale scene, seed-fixed. Each shape is timed
with `chip_smoke.timed` (CUDA events, 20 calls after warm-up) `--reps`
times. Prints the card line, then one JSON line per shape. To compare two
trees, run them in one call: A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    # the tree under test first: its unislam_tpu_torch is the one imported
    sys.path[:0] = [tree, HERE]
    import torch

    import chip_smoke as cs
    from unislam_tpu_torch.kernels.scatter_accum import scatter_accumulate
    from unislam_tpu_torch.models import brick_encoding as be
    from unislam_tpu_torch.models import hash_encoding as he

    if not torch.cuda.is_available():
        print("k9_timing: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.card_line())
    gen = torch.Generator().manual_seed(1)
    shapes = []
    cfg, ds = cs.room0_setup(1, "room0.yaml")
    pts, sc, _ = cs.main_path_points(cfg, ds, 4200, dev, 11)
    for grid, spec in (("sdf", sc.sdf_spec), ("color", sc.color_spec)):
        table = he.init_table(spec, gen, dev)
        g = torch.randn(pts.shape[0], spec.out_dim, generator=gen).to(dev)
        _, idx, rows = he.encode_bwd(table, pts, g, spec, True, True)
        shapes.append((f"hash {grid}/map", idx, rows, spec.total_entries))
    cfg, ds = cs.room0_setup(1, "room0_tpu.yaml")
    n_fine = cfg["rendering"]["n_fine"]
    pts, sc, band = cs.main_path_points(cfg, ds, 4200, dev, 11, n_fine)
    spec = sc.brick_spec
    table = be.init_table(spec, gen, dev)
    coarse, fine = be.coarse_fine_split(spec, cfg["rendering"]["lod_split"])
    idx, rows = [], []
    for p, lv in ((pts, coarse), (band, fine)):
        g = torch.randn(p.shape[0], len(lv) * spec.n_features,
                        generator=gen).to(dev)
        _, i, r = be.encode_bwd(table, p, g, spec, lv, True, True)
        idx.append(i)
        rows.append(r)
    shapes.append(("brick map", torch.cat(idx), torch.cat(rows),
                   spec.total_rows * 27))
    for name, idx, rows, n_rows in shapes:
        ms = [cs.timed(lambda: scatter_accumulate(idx, rows, n_rows), dev)
              for _ in range(args.reps)]
        print(json.dumps({"tree": tree, "shape": name,
                          "M": int(rows.shape[0]), "D": int(rows.shape[1]),
                          "rows": n_rows, "ms": ms,
                          "ms_min": min(ms)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
