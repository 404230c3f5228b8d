"""Point-cloud figures (port of ``visualization/visualization.py``;
reference ``visualization/visualization.py:6-32``).

One row of 3-D scatter panels (Input / Coarse / Dense / Ground Truth)
written as a PNG, the trainer's per-epoch figure.  Host code: tensors are
copied to the host first.  matplotlib (and open3d for the interactive
viewer) is imported inside each function, so the package imports without
either.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def _host(pc) -> np.ndarray:
    if isinstance(pc, torch.Tensor):
        return pc.detach().cpu().numpy()
    return np.asarray(pc)


def o3d_visualize_pc(pc) -> None:
    """Interactive viewer (reference ``visualization.py:6-9``); needs the
    optional open3d package."""
    try:
        import open3d as o3d
    except ImportError as e:
        raise ImportError("o3d_visualize_pc needs the optional open3d package; "
                          "plot_pcd_one_view needs matplotlib only") from e
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(_host(pc).astype(np.float64))
    o3d.visualization.draw_geometries([pcd])


def plot_pcd_one_view(filename: str, pcds: Sequence, titles: Sequence[str],
                      suptitle: str = "", sizes: Optional[List[float]] = None,
                      cmap: str = "Reds", zdir: str = "y", xlim=(-0.3, 0.3),
                      ylim=(-0.3, 0.3), zlim=(-0.3, 0.3)) -> None:
    """One PNG of ``pcds`` ((N_i, 3) tensors or arrays) side by side, the
    JAX package's figure: view (30, -120), colour by x, axes off."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if sizes is None:
        sizes = [0.5 for _ in pcds]
    fig = plt.figure(figsize=(len(pcds) * 3, 3))
    for i, (pcd, title) in enumerate(zip(pcds, titles)):
        pcd = _host(pcd)
        ax = fig.add_subplot(1, len(pcds), i + 1, projection="3d")
        ax.view_init(30, -120)
        ax.scatter(pcd[:, 0], pcd[:, 1], pcd[:, 2], zdir=zdir, c=pcd[:, 0], s=sizes[i],
                   cmap=cmap, vmin=-1.0, vmax=0.5)
        ax.set_title(title)
        ax.set_axis_off()
        ax.set_xlim(xlim)
        ax.set_ylim(ylim)
        ax.set_zlim(zlim)
    if suptitle:
        fig.suptitle(suptitle)
    fig.tight_layout()
    fig.savefig(filename, dpi=120)
    plt.close(fig)


def visualize_pc(pcd, title: str = "point cloud") -> None:
    """Interactive single-cloud viewer on matplotlib (no open3d); headless
    hosts use :func:`plot_pcd_one_view`."""
    import matplotlib.pyplot as plt

    pcd = _host(pcd)
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pcd[:, 0], pcd[:, 1], pcd[:, 2], s=0.5, c=pcd[:, 0], cmap="Reds")
    ax.set_title(title)
    plt.show()
