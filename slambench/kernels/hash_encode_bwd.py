"""K2, the hash-grid backward (`csrc/hash_encode.cu`): the point gradient
of both grids in every tracking and mapping iteration, and in mapping also
the table-gradient rows that K9 reduces.

A launch of N points on a grid of T entries, L levels: points and their
gradient (12 B each way), the cotangent (8 B a point and level) and the
table (8 B an entry) read once; with rows, 8 rows a point and level
written (a 4 B index and 8 B of values each); 12 operations a corner."""

TRACE = ("hash_bwd_kernel",)


def cost(N: int, grid: dict, rows: bool) -> tuple:
    L, T = grid["L"], grid["T"]
    return (N * 12 + N * L * 8 + T * 8 + N * 12 + rows * N * L * 8 * 12,
            N * L * 8 * 12)


def launches(shp: dict, it: dict) -> list:
    S = shp["samples"]
    return [(it[kind], *cost(rays * S, grid, kind == "map"))
            for kind, rays in (("track", shp["track_rays"]),
                               ("map", shp["map_rays"]))
            for grid in shp["grids"].values()]
