"""Partial scans of a complete cloud by a z-buffer depth camera (port of
``data/render.py``; the reference renders 8 camera poses in Blender,
``render/render_depth.py:33-141``, and back-projects the depth maps,
``render/process_exr.py:34-86``).

A camera on a sphere around the origin looks at it through a pinhole
(~57 degree field of view on a square image).  Every point stamps its depth
on a (2 splat + 1)^2 pixel footprint of a depth buffer, the nearest depth
winning; a point is visible where its depth is within ``depth_tol``
(relative) of the buffer at its own pixel.

On a tensor device (the card by default): the projection and the depths in
float64, as numpy computes them, by elementwise products and sums, so the
card and the CPU give the same bits (the camera rotations, 3 x 3 a view,
are formed on the host in numpy); the depth buffer by one
``scatter_reduce_(..., "amin")`` over every footprint pixel, exact in any
order.  Points behind the camera (z <= 1e-6) and points outside the image
are masked, not compacted: they take depth +inf and stamp nothing, and
their division is guarded before the cast to int64.  :func:`generate_partials`
renders all its views in one pass over one flat (views x pixels) buffer.
The camera poses are drawn on the host by ``np.random.default_rng(seed)``,
as JAX draws them, and each partial holds JAX's points in JAX's order.

    python -m vn_pointcloudcompletion_tpu_torch.data.render <root> [--split train]
        [--n_views 8] [--seed 0] [--device cpu]

renders ``<root>/<split>/complete/<cat>/<model>.ply`` into
``<root>/<split>/partial/<cat>/<model>_<k>.ply`` (``<model>.ply``, the first
view, on a split other than ``train``), as ``tools/render_partials.py`` does,
with the same seed per model.
"""

from __future__ import annotations

import argparse
import os
import time
import zlib
from typing import List

import numpy as np
import torch

from vn_pointcloudcompletion_tpu_torch.data.ply import read_ply_points, write_ply_points
from vn_pointcloudcompletion_tpu_torch.utils.device import resolve_device


def _look_at_host(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    fwd = target - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, fwd)) > 0.999:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right) + 1e-12
    true_up = np.cross(right, fwd)
    return np.stack([right, -true_up, fwd], axis=0)


def look_at(eye, target, device=None) -> torch.Tensor:
    """World -> camera rotation (rows: right, down, forward) of a camera at
    ``eye`` looking at ``target``: (..., 3) -> (..., 3, 3) float64 on
    ``device`` (default: ``eye``'s, the CPU for an array).  Host work on a
    few vectors, in numpy as JAX forms it, so every device takes JAX's
    camera to the bit."""
    if device is None:
        device = eye.device if isinstance(eye, torch.Tensor) else "cpu"
    eyes = _host(eye)
    target = np.broadcast_to(_host(target), eyes.shape)
    rots = [_look_at_host(e, t) for e, t in zip(eyes.reshape(-1, 3), target.reshape(-1, 3))]
    return torch.from_numpy(np.stack(rots).reshape(eyes.shape + (3,))).to(device)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.float64)


def _visible(points: torch.Tensor, eyes: np.ndarray, image_size: int, focal: float,
             splat: int, depth_tol: float) -> torch.Tensor:
    """(V, N) mask of the points each of the V cameras at ``eyes`` (host
    float64) sees, on ``points``' device."""
    dev = points.device
    n_views, n = eyes.shape[0], points.shape[0]
    r = look_at(eyes, np.zeros(3), dev)  # (V, 3, 3)
    d = points.to(torch.float64)[None] - torch.from_numpy(eyes).to(dev)[:, None]  # (V, N, 3)
    # cam = d @ r^T, each coordinate summed left to right
    cam = [d[..., 0] * r[:, i, None, 0] + d[..., 1] * r[:, i, None, 1]
           + d[..., 2] * r[:, i, None, 2] for i in range(3)]
    z = cam[2]
    front = z > 1e-6
    zs = torch.where(front, z, 1.0)
    half = image_size / 2
    u = torch.round(focal * torch.where(front, cam[0], 0.0) / zs + half)
    v = torch.round(focal * torch.where(front, cam[1], 0.0) / zs + half)
    ok = front & (u >= 0) & (u < image_size) & (v >= 0) & (v < image_size)
    u = torch.where(ok, u, 0.0).to(torch.int64)
    v = torch.where(ok, v, 0.0).to(torch.int64)
    z = torch.where(ok, z, float("inf"))

    pixels = image_size * image_size
    base = torch.arange(n_views, device=dev)[:, None] * pixels
    offsets = torch.arange(-splat, splat + 1, device=dev)
    uu = (u[None] + offsets[:, None, None]).clamp(0, image_size - 1)  # (S, V, N)
    vv = (v[None] + offsets[:, None, None]).clamp(0, image_size - 1)
    stamp = (base + vv[None] * image_size + uu[:, None]).reshape(-1)  # (S, S, V, N)
    depth = torch.full((n_views * pixels,), float("inf"), dtype=torch.float64, device=dev)
    depth.scatter_reduce_(0, stamp, z.expand(len(offsets) ** 2, n_views, n).reshape(-1),
                          reduce="amin")
    own = depth[base + v * image_size + u]
    return ok & (z <= own * (1.0 + depth_tol))


def render_partial(points, eye, image_size: int = 160, focal: float = 140.0,
                   splat: int = 1, depth_tol: float = 0.03, device=None) -> torch.Tensor:
    """The points of ``points`` (N, 3) that a camera at ``eye`` (3,) sees,
    in their order, on ``device`` (default: ``points``' own, the card for
    a numpy array)."""
    pts = _on_device(points, device)
    mask = _visible(pts, _host(eye)[None], image_size, focal, splat, depth_tol)[0]
    return pts[mask]


def sample_camera_poses(n_views: int, radius: float, rng: np.random.Generator,
                        device="cpu") -> torch.Tensor:
    """Uniform directions on the view sphere times ``radius``, drawn from
    ``rng`` and scaled on the host as JAX does: (n_views, 3) float64 on
    ``device``."""
    return torch.from_numpy(_poses_host(n_views, radius, rng)).to(device)


def _poses_host(n_views: int, radius: float, rng: np.random.Generator) -> np.ndarray:
    v = rng.standard_normal((n_views, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
    return v * radius


def generate_partials(complete, n_views: int = 8, radius_scale: float = 3.0,
                      image_size: int = 160, focal: float = 140.0, seed: int = 0,
                      device=None) -> List[torch.Tensor]:
    """One partial scan per camera pose (the reference's 8-view protocol),
    the views rendered in one pass: a list of ``n_views`` (M_k, 3) tensors
    on ``device`` (default as :func:`render_partial`)."""
    pts = _on_device(complete, device)
    rng = np.random.default_rng(seed)
    # in the cloud's dtype, as numpy rounds a float32 cloud's scale and radius
    radius = radius_scale * (pts.abs().max() + 1e-9)
    eyes = _poses_host(n_views, float(radius), rng)
    mask = _visible(pts, eyes, image_size, focal, 1, 0.03)
    _, idx = mask.nonzero(as_tuple=True)  # row-major: by view, then point
    return list(pts[idx].split(mask.sum(1).tolist()))


def _on_device(points, device) -> torch.Tensor:
    if isinstance(points, torch.Tensor):
        return points if device is None else points.to(resolve_device(device))
    return torch.from_numpy(np.asarray(points)).to(resolve_device(device or "cuda"))


def render_root(root: str, split: str = "train", n_views: int = 8, seed: int = 0,
                device="cuda") -> int:
    """Render the partial scans of every complete cloud of a PCN-layout
    ``root``'s ``split``; returns the number of models."""
    dev = resolve_device(device)
    complete_root = os.path.join(root, split, "complete")
    partial_root = os.path.join(root, split, "partial")
    n_models = 0
    for cat in sorted(os.listdir(complete_root)):
        os.makedirs(os.path.join(partial_root, cat), exist_ok=True)
        for fname in sorted(os.listdir(os.path.join(complete_root, cat))):
            if not fname.endswith(".ply"):
                continue
            model_id = fname[:-4]
            complete = read_ply_points(os.path.join(complete_root, cat, fname))
            # crc32, not hash(): str hashes are salted per process
            model_seed = seed + zlib.crc32(f"{cat}/{model_id}".encode()) % (2**31)
            partials = generate_partials(complete, n_views=n_views, seed=model_seed,
                                         device=dev)
            if split == "train":
                for k, part in enumerate(partials):
                    write_ply_points(os.path.join(partial_root, cat, f"{model_id}_{k}.ply"),
                                     part.cpu().numpy())
            else:
                write_ply_points(os.path.join(partial_root, cat, f"{model_id}.ply"),
                                 partials[0].cpu().numpy())
            n_models += 1
    return n_models


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="dataset root (holds <split>/complete/<cat>/<model>.ply)")
    ap.add_argument("--split", default="train")
    ap.add_argument("--n_views", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    n = render_root(args.root, args.split, args.n_views, args.seed, args.device)
    print(f"rendered partials for {n} models -> "
          f"{os.path.join(args.root, args.split, 'partial')} "
          f"({time.perf_counter() - t0:.2f} s)")
    return n


if __name__ == "__main__":
    main()
