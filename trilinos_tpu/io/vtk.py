"""Mesh + field output/input: legacy VTK unstructured grids.

Reference role: packages/seacas (Exodus II mesh/results I/O) and the
STK mesh-I/O layer — the reference writes Exodus (netCDF) files that
visualization tools read. The portable equivalent is the
legacy ASCII VTK format (readable by ParaView/VisIt, zero external
dependencies): one ``UNSTRUCTURED_GRID`` per file with POINT_DATA /
CELL_DATA scalar and vector fields, plus a minimal reader for
round-trip checkpointing of fem meshes and solution fields.

Time series follow the Exodus convention of one results set per step:
``write_vtk_series`` emits ``name_0000.vtk, name_0001.vtk, …`` plus a
ParaView ``.series`` JSON index.

The fem tensor cells (quad4/hex8) use LEXICOGRAPHIC vertex order (the
1-D-product geometry basis); VTK wants CCW bottom-then-top. The writer
permutes connectivity to VTK order and the reader permutes it back, so
files are ParaView-valid and the round trip returns fem order.
"""

from __future__ import annotations

import json
import os

import numpy as np

_VTK_CELL_TYPE = {
    "line2": 3,    # VTK_LINE
    "tri3": 5,     # VTK_TRIANGLE
    "quad4": 9,    # VTK_QUAD
    "tet4": 10,    # VTK_TETRA
    "hex8": 12,    # VTK_HEXAHEDRON
}
_CELL_NAME_BY_TYPE = {v: k for k, v in _VTK_CELL_TYPE.items()}

# fem lexicographic -> VTK CCW vertex permutation per topology
_TO_VTK_ORDER = {
    "quad4": np.array([0, 2, 3, 1]),
    "hex8": np.array([0, 4, 6, 2, 1, 5, 7, 3]),
}


def _perm(topo_name, inverse=False):
    p = _TO_VTK_ORDER.get(topo_name)
    if p is None:
        return None
    return np.argsort(p) if inverse else p


def _pad3(coords):
    """VTK points are always 3-D; zero-pad 1-D/2-D coordinates."""
    coords = np.asarray(coords, dtype=np.float64)
    if coords.ndim != 2:
        raise ValueError("coords must be (n_points, dim)")
    if coords.shape[1] < 3:
        pad = np.zeros((coords.shape[0], 3 - coords.shape[1]))
        coords = np.hstack([coords, pad])
    return coords


def _write_field_block(f, name, data, n_expected, kind):
    data = np.asarray(data, dtype=np.float64)
    if data.shape[0] != n_expected:
        raise ValueError(
            f"{kind} field {name!r}: leading dim {data.shape[0]} != "
            f"{n_expected}")
    if data.ndim == 1:
        f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
        np.savetxt(f, data, fmt="%.17g")
    elif data.ndim == 2 and data.shape[1] <= 3:
        f.write(f"VECTORS {name} double\n")
        np.savetxt(f, _pad3(data), fmt="%.17g")
    else:
        raise ValueError(
            f"field {name!r}: expected (n,) scalars or (n,<=3) vectors, "
            f"got shape {data.shape}")


def write_vtk(path, mesh, point_data=None, cell_data=None,
              title="trilinos_tpu"):
    """Write a fem ``Mesh`` (or any (topo_name, coords, connect) triple)
    with named nodal/cell fields as a legacy ASCII VTK file."""
    topo_name = getattr(getattr(mesh, "topo", None), "name", None) \
        or mesh[0]
    coords = mesh.coords if hasattr(mesh, "coords") else mesh[1]
    connect = mesh.connect if hasattr(mesh, "connect") else mesh[2]
    if topo_name not in _VTK_CELL_TYPE:
        raise ValueError(f"unsupported cell topology {topo_name!r}")
    ctype = _VTK_CELL_TYPE[topo_name]
    coords3 = _pad3(coords)
    connect = np.asarray(connect, dtype=np.int64)
    p = _perm(topo_name)
    if p is not None:
        connect = connect[:, p]
    ne, nv = connect.shape

    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(f"{title}\n")
        f.write("ASCII\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {coords3.shape[0]} double\n")
        np.savetxt(f, coords3, fmt="%.17g")
        f.write(f"CELLS {ne} {ne * (nv + 1)}\n")
        np.savetxt(f, np.hstack([np.full((ne, 1), nv), connect]),
                   fmt="%d")
        f.write(f"CELL_TYPES {ne}\n")
        np.savetxt(f, np.full(ne, ctype), fmt="%d")
        if point_data:
            f.write(f"POINT_DATA {coords3.shape[0]}\n")
            for name, data in point_data.items():
                _write_field_block(f, name, data, coords3.shape[0],
                                   "point")
        if cell_data:
            f.write(f"CELL_DATA {ne}\n")
            for name, data in cell_data.items():
                _write_field_block(f, name, data, ne, "cell")


def write_vtk_series(basename, mesh, steps, times=None,
                     title="trilinos_tpu"):
    """Write a time series (Exodus results-per-step analogue):
    ``steps`` is a sequence of (point_data, cell_data) dicts. Emits
    ``basename_{i:04d}.vtk`` plus a ParaView ``.series`` index; returns
    the list of written .vtk paths."""
    times = list(times) if times is not None \
        else [float(i) for i in range(len(steps))]
    if len(times) != len(steps):
        raise ValueError("len(times) != len(steps)")
    paths, files = [], []
    for i, step in enumerate(steps):
        pd, cd = step if isinstance(step, tuple) else (step, None)
        p = f"{basename}_{i:04d}.vtk"
        write_vtk(p, mesh, point_data=pd, cell_data=cd, title=title)
        paths.append(p)
        files.append({"name": os.path.basename(p), "time": times[i]})
    with open(f"{basename}.vtk.series", "w") as f:
        json.dump({"file-series-version": "1.0", "files": files}, f)
    return paths


def read_vtk(path):
    """Read a legacy ASCII VTK unstructured grid (the subset write_vtk
    emits). Returns (topo_name, coords(float64), connect(int64),
    point_data, cell_data)."""
    with open(path) as f:
        tokens = f.read().split()
    pos = 0

    def take(n):
        nonlocal pos
        out = tokens[pos:pos + n]
        pos += n
        return out

    def seek(word):
        nonlocal pos
        while tokens[pos] != word:
            pos += 1

    seek("POINTS")
    n_pts = int(take(2)[1])
    take(1)  # dtype
    coords = np.array(take(3 * n_pts), dtype=np.float64).reshape(-1, 3)
    seek("CELLS")
    ne, total = int(tokens[pos + 1]), int(tokens[pos + 2])
    take(3)
    raw = np.array(take(total), dtype=np.int64).reshape(ne, -1)
    connect = raw[:, 1:]
    seek("CELL_TYPES")
    take(2)
    ctype = int(take(ne)[0])
    topo_name = _CELL_NAME_BY_TYPE[ctype]
    pinv = _perm(topo_name, inverse=True)
    if pinv is not None:
        connect = connect[:, pinv]

    def read_fields(n):
        out = {}
        while pos < len(tokens) and tokens[pos] in ("SCALARS", "VECTORS"):
            kind = tokens[pos]
            name = tokens[pos + 1]
            if kind == "SCALARS":
                take(4)  # SCALARS name dtype ncomp
                take(2)  # LOOKUP_TABLE default
                out[name] = np.array(take(n), dtype=np.float64)
            else:
                take(3)  # VECTORS name dtype
                out[name] = np.array(take(3 * n),
                                     dtype=np.float64).reshape(-1, 3)
        return out

    point_data, cell_data = {}, {}
    while pos < len(tokens):
        if tokens[pos] == "POINT_DATA":
            take(2)
            point_data = read_fields(n_pts)
        elif tokens[pos] == "CELL_DATA":
            take(2)
            cell_data = read_fields(ne)
        else:
            pos += 1
    return topo_name, coords, connect, point_data, cell_data
