"""K9, the order-independent fixed-point scatter-accumulate
(`csrc/scatter_accum.cu`, passes A, B and C), which sums K2's rows into
each grid's table gradient once a mapping iteration.

A launch of M = 8 L N rows of D = 2 into T destinations: indices (4 B)
and values (8 B) of the rows read once, the gradient (8 B an entry)
written once; one operation a value."""

TRACE = ("pass_a_kernel", "pass_b_kernel", "pass_c_kernel")


def cost(N: int, grid: dict) -> tuple:
    M, D, T = 8 * grid["L"] * N, 2, grid["T"]
    return M * 4 + M * D * 4 + T * D * 4, M * D


def launches(shp: dict, it: dict) -> list:
    N = shp["map_rays"] * shp["samples"]
    return [(it["map"], *cost(N, grid)) for grid in shp["grids"].values()]
