"""Minimal PLY point reader/writer in numpy (port of ``data/ply.py``).

Reads the vertex x/y/z of ascii, binary_little_endian and binary_big_endian
files with integer or float properties (others are parsed and dropped);
writes binary_little_endian.  As in the JAX package, the C++ reader
``tools/fastply.cpp`` (``data/fastply_binding.py``, built at first use) reads
first, and the numpy reader takes every file it does not read or every
file where it could not be built; :data:`READERS` counts which reader
returned each file.
"""

from __future__ import annotations

import collections

import numpy as np

from vn_pointcloudcompletion_tpu_torch.data import fastply_binding

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


READERS: collections.Counter = collections.Counter()  # "fastply" / "numpy": files read


def read_ply_points(path: str) -> np.ndarray:
    """Read the vertex x/y/z of a PLY file -> (N, 3) float32."""
    pts = fastply_binding.read_points(path)
    if pts is not None:
        READERS["fastply"] += 1
        return pts
    READERS["numpy"] += 1
    return read_ply_points_numpy(path)


def read_ply_points_numpy(path: str) -> np.ndarray:
    """The numpy reader."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
            if len(header_lines) > 200:
                raise ValueError(f"{path}: PLY header too long / malformed")

        fmt = None
        n_vertices = 0
        props = []  # (name, numpy-type) for the vertex element
        in_vertex = False
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertices = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError(f"{path}: list property on vertex element")
                props.append((parts[-1], _PLY_TYPES[parts[1]]))

        names = [p[0] for p in props]
        if not {"x", "y", "z"}.issubset(names):
            raise ValueError(f"{path}: vertex element lacks x/y/z")

        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n_vertices, ndmin=2)
            cols = [names.index(c) for c in ("x", "y", "z")]
            return data[:, cols].astype(np.float32)

        endian = "<" if fmt == "binary_little_endian" else ">"
        dtype = np.dtype([(n, endian + t) for n, t in props])
        raw = np.frombuffer(f.read(dtype.itemsize * n_vertices), dtype=dtype)
        out = np.empty((n_vertices, 3), np.float32)
        for i, c in enumerate(("x", "y", "z")):
            out[:, i] = raw[c]
        return out


def write_ply_points(path: str, points: np.ndarray) -> None:
    """Write (N, 3) points as a binary_little_endian PLY."""
    pts = np.ascontiguousarray(points, np.float32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(pts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(pts.tobytes())
