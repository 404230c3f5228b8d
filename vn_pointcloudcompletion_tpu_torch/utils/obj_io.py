"""Voxel grid -> OBJ cube soup (port of ``utils/obj_io.py``; reference
``utils/voxel_util.py:22-66``, ``voxel2mesh``/``write_obj``/``voxel2obj``).

The grid is thresholded on its own device; with ``surface_view`` the
voxels whose 26 neighbours are all occupied are dropped by a 3x3x3 erosion
over a grid padded with empty voxels, so a voxel on the grid's edge is
always kept (JAX's 27 shifted ANDs; a ``max_pool3d`` pads with -inf, so the
padding here is explicit).  Every cube's 8 vertices and 12 triangles come
out of one broadcast, the voxels in ``np.argwhere``'s lexicographic order.
The natural input is ``metrics/metrics.py::points_to_voxels`` (64^3).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# The unit cube's 8 vertices and 12 triangles (faces 1-based, as OBJ counts)
_CUBE_VERTS = [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
               [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]]
_CUBE_FACES = [[1, 2, 3], [2, 4, 3], [3, 4, 7], [4, 8, 7], [1, 3, 7], [1, 7, 5],
               [1, 6, 2], [1, 5, 6], [7, 8, 6], [7, 6, 5], [2, 8, 4], [2, 6, 8]]
_SCALE = 0.01
_CUBE_DIST_SCALE = 1.1


def _erode27(occ: torch.Tensor) -> torch.Tensor:
    """True where a voxel and its 26 neighbours are occupied, the grid's
    outside counted empty."""
    padded = F.pad(occ.to(torch.float32)[None, None], (1, 1, 1, 1, 1, 1), value=0.0)
    return (-F.max_pool3d(-padded, 3, stride=1))[0, 0] > 0.5


def voxel2mesh(voxels, surface_view: bool = True,
               threshold: float = 0.3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxels above ``threshold`` -> (verts (8 M, 3) float64, faces (12 M, 3)
    int64), on the grid's device: cubes at ``1.1 * index`` scaled by 0.01,
    the reference's export geometry; with ``surface_view`` the enclosed
    voxels are left out."""
    grid = torch.as_tensor(voxels)
    occ = grid > threshold
    keep = occ & ~_erode27(occ) if surface_view else occ
    ijk = keep.nonzero()  # (M, 3), lexicographic
    cube = torch.tensor(_CUBE_VERTS, dtype=torch.int64, device=grid.device)
    faces = torch.tensor(_CUBE_FACES, dtype=torch.int64, device=grid.device)
    verts = _SCALE * (_CUBE_DIST_SCALE * ijk[:, None, :].to(torch.float64) + cube[None])
    faces = faces[None] + 8 * torch.arange(len(ijk), device=grid.device)[:, None, None]
    return verts.reshape(-1, 3), faces.reshape(-1, 3)


def write_obj(filename: str, verts, faces) -> None:
    """The reference's OBJ text (``voxel_util.py:50-61``), byte for byte
    the JAX package's ``np.savetxt`` formats."""
    verts = torch.as_tensor(verts).cpu().numpy()
    faces = torch.as_tensor(faces).cpu().numpy()
    with open(filename, "w") as f:
        f.write("g\n# %d vertex\n" % len(verts))
        np.savetxt(f, verts, fmt="v %f %f %f")
        f.write("# %d faces\n" % len(faces))
        np.savetxt(f, faces, fmt="f %d %d %d")


def voxel2obj(filename: str, pred, surface_view: bool = True) -> None:
    verts, faces = voxel2mesh(pred, surface_view)
    write_obj(filename, verts, faces)
