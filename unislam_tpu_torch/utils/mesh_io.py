"""Minimal PLY mesh IO (binary little-endian), a copy of
`unislam_tpu/utils/mesh_io.py` (no trimesh)."""

from __future__ import annotations

import numpy as np


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              vertex_colors: np.ndarray | None = None) -> None:
    """vertices (V,3) float, faces (F,3) int, vertex_colors (V,3) float [0,1]
    or uint8."""
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    has_color = vertex_colors is not None
    if has_color:
        vc = np.asarray(vertex_colors)
        if vc.dtype != np.uint8:
            vc = np.clip(vc * 255.0, 0, 255).astype(np.uint8)

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(vertices)}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {len(faces)}",
               "property list uchar int vertex_indices", "end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            vdt = np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            vbuf = np.empty(len(vertices), dtype=vdt)
            vbuf["xyz"] = vertices
            vbuf["rgb"] = vc
        else:
            vdt = np.dtype([("xyz", np.float32, 3)])
            vbuf = np.empty(len(vertices), dtype=vdt)
            vbuf["xyz"] = vertices
        f.write(vbuf.tobytes())
        fdt = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])
        fbuf = np.empty(len(faces), dtype=fdt)
        fbuf["n"] = 3
        fbuf["idx"] = faces
        f.write(fbuf.tobytes())


def read_ply(path: str):
    """Returns (vertices (V,3) f32, faces (F,3) i64, colors (V,3) u8 or
    None). Handles the binary-LE files written by write_ply and common ascii
    PLYs."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    body = data[end:]

    fmt = next(l.split()[1] for l in header if l.startswith("format"))
    n_vert = n_face = 0
    vert_props = []
    cur = None
    for l in header:
        t = l.split()
        if not t:
            continue
        if t[0] == "element":
            cur = t[1]
            if t[1] == "vertex":
                n_vert = int(t[2])
            elif t[1] == "face":
                n_face = int(t[2])
        elif t[0] == "property" and cur == "vertex" and t[1] != "list":
            vert_props.append((t[2], t[1]))

    type_map = {"float": np.float32, "float32": np.float32,
                "double": np.float64, "uchar": np.uint8, "uint8": np.uint8,
                "int": np.int32, "uint": np.uint32}

    if fmt == "ascii":
        text = body.decode("ascii").split("\n")
        vrows = np.array([[float(x) for x in text[i].split()]
                          for i in range(n_vert)])
        names = [n for n, _ in vert_props]
        xyz = vrows[:, [names.index("x"), names.index("y"),
                        names.index("z")]].astype(np.float32)
        colors = None
        if "red" in names:
            colors = vrows[:, [names.index("red"), names.index("green"),
                               names.index("blue")]].astype(np.uint8)
        faces = np.array([[int(x) for x in text[n_vert + i].split()][1:4]
                          for i in range(n_face)], dtype=np.int64)
        return xyz, faces, colors

    vdt = np.dtype([(n, type_map[t]) for n, t in vert_props])
    vbuf = np.frombuffer(body, dtype=vdt, count=n_vert)
    off = vdt.itemsize * n_vert
    xyz = np.stack([vbuf["x"], vbuf["y"], vbuf["z"]], axis=-1).astype(np.float32)
    colors = None
    names = [n for n, _ in vert_props]
    if "red" in names:
        colors = np.stack([vbuf["red"], vbuf["green"], vbuf["blue"]],
                          axis=-1).astype(np.uint8)
    fdt = np.dtype([("n", np.uint8), ("idx", np.int32, 3)])
    fbuf = np.frombuffer(body, dtype=fdt, count=n_face, offset=off)
    return xyz, fbuf["idx"].astype(np.int64), colors


def remove_unreferenced(vertices, faces, colors=None):
    """Drop vertices not used by any face and reindex."""
    used = np.zeros(len(vertices), dtype=bool)
    used[np.asarray(faces).reshape(-1)] = True
    remap = np.cumsum(used) - 1
    new_faces = remap[np.asarray(faces)]
    new_colors = colors[used] if colors is not None else None
    return vertices[used], new_faces, new_colors
