"""K1, the hash-grid forward (`csrc/hash_encode.cu`), for every grid a
render encodes: both grids at every sample of a tracking or mapping
iteration's rays, the SDF grid at the probe's uniform samples.

A launch of N points on a grid of T entries, L levels of F = 2: points
read once (12 B each), the table read whole (8 B an entry), the
features written once (8 B a point and level); 4 operations a corner's
weighted feature (32 a point and level)."""

TRACE = ("hash_fwd_kernel",)


def cost(N: int, grid: dict) -> tuple:
    L, T = grid["L"], grid["T"]
    return N * 12 + T * 8 + N * L * 8, N * L * 8 * 4


def launches(shp: dict, it: dict) -> list:
    g, S = shp["grids"], shp["samples"]
    rows = []
    for kind, rays in (("track", shp["track_rays"]),
                       ("map", shp["map_rays"])):
        for grid in g.values():
            rows.append((it[kind], *cost(rays * S, grid)))
    rows.append((it["probe"], *cost(shp["map_rays"] * shp["probe_samples"],
                                    g["sdf"])))
    return rows
