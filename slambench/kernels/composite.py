"""K3, volume compositing (`csrc/composite.cu`): one forward and one
backward a tracking or mapping iteration, and one probe-mode launch a
probe iteration.

R rays of S samples. Forward: raw and z read once (20 B a sample), five
outputs written (28 B a ray); about 40 operations a sample. Probe: sdf
and z read, w written (12 B a sample), sum w z (4 B a ray); 12 a sample.
Backward: raw and z read, d raw written (36 B a sample), the saved depth
and the loop's two cotangents read (20 B a ray); about 60 a sample."""

TRACE = ("composite_fwd_kernel", "composite_bwd_kernel",
         "composite_probe_kernel")


def launches(shp: dict, it: dict) -> list:
    S, P = shp["samples"], shp["probe_samples"]
    rows = []
    for kind, R in (("track", shp["track_rays"]), ("map", shp["map_rays"])):
        rows.append((it[kind], R * S * 20 + R * 28 + 4, R * S * 40))
        rows.append((it[kind], R * S * 36 + R * 20 + 8, R * S * 60))
    R = shp["map_rays"]
    rows.append((it["probe"], R * P * 12 + R * 4 + 4, R * P * 12))
    return rows
