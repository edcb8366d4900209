"""The mapping step's Adam over every scene leaf (both tables, the
decoders, beta) and the keyframe poses, once a mapping iteration
(`torch.optim.Adam`). Counted for `mfu`.

A parameter, its gradient and both moments read and the three written
(28 B an element); about 12 operations an element."""

TRACE = ()


def launches(shp: dict, it: dict) -> list:
    n = sum(2 * g["T"] for g in shp["grids"].values())
    n += sum(a * b + b for mlp in shp["mlp"].values()
             for a, b in zip(mlp[:-1], mlp[1:]))
    return [(it["map"], n * 28, n * 12)]
