"""The SDF and colour decoders (biased f32 MLPs, 32 -> 16 -> 16 -> out,
cuBLAS products): both heads at every sample of a tracking or mapping
iteration, the SDF head at the probe's samples. Counted for `mfu`; it has
no kernel of its own, so it gives no roofline share.

2 operations a weight a point forward; the backward takes the input
gradient (tracking) and also the weight gradient (mapping), each as much
as the forward. Weights and activations stay on chip between layers, so
the bytes are each head's input features read and output written."""

TRACE = ()


def head(N: int, dims) -> tuple:
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return N * (dims[0] + dims[-1]) * 4, 2 * macs * N


def launches(shp: dict, it: dict) -> list:
    S, mlp = shp["samples"], shp["mlp"]
    rows = []
    for kind, R, passes in (("track", shp["track_rays"], 2),
                            ("map", shp["map_rays"], 3)):
        for dims in mlp.values():
            b, f = head(R * S, dims)
            rows.append((it[kind], passes * b, passes * f))
    rows.append((it["probe"], *head(shp["map_rays"] * shp["probe_samples"],
                                    mlp["sdf"])))
    return rows
