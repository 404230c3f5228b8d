"""Kernels F and K3 on the CPU: which design K3 runs at each of the paths'
shapes, the host rules of its gather, F's probe, and the plain versions
against the JAX package at the paths' new shapes.

``ops/knn_pallas.py::edge_design`` gives kernel K3 the "coords" design over
coordinates (D <= 4), the "tiled" design over features (D > 4, N <= 512)
and the parent "warp" design where neither reaches; both new designs end in
a gather whose threads split the neighbour slots as ``gather_slots`` says.
The CUDA kernels take what the wrapper picks, so the choice for every K3
call of the VN DGCNN and vn_pointr pipelines is checked here, where no card
is needed.  The plain versions, which the card holds the kernels to bit for
bit (``gpu`` tests of ``tests/test_torch_port_kernels.py``), are held
against JAX's Pallas kernels in interpret mode: K3 here over vn_pointr's D
192 features, F at the paths' shapes in
``tests/test_torch_port_dgcnn.py::test_f_plain_matches_pallas_and_jnp``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_dgcnn import _assert_knn_gap
from vn_pointcloudcompletion_tpu.ops import knn_pallas as jax_knn_pallas
from vn_pointcloudcompletion_tpu_torch.ops import fps_pallas as port_fps
from vn_pointcloudcompletion_tpu_torch.ops import knn_pallas as port_knn
from vn_pointcloudcompletion_tpu_torch.utils.config import Config

torch.set_num_threads(2)

# (N, D, C3, k) of every K3 call of one eval forward at 2048 input points,
# and its design: the VN DGCNN's conv4 and conv5 over the FPS coordinates,
# vn_pointr's conv4-conv6 over the grouper's features
_K3_CALLS = {
    "vn_dgcnn": ("vn_dgcnn_fps", "vn_foldingnet", 1024,
                 {(512, 3, 384, 16): "coords", (512, 3, 768, 16): "coords"}),
    "vn_pointr": ("vn_pointr", "attention_vn_foldingnet", 448,
                  {(512, 96, 384, 16): "tiled", (512, 192, 384, 16): "tiled",
                   (128, 192, 768, 16): "tiled"}),
}
# (N, S) of every F call of the same forwards
_F_CALLS = {"vn_dgcnn": {(2048, 512), (512, 128)},
            "vn_pointr": {(2048, 512), (512, 128), (2048, 224)}}


@pytest.mark.parametrize("name", list(_K3_CALLS))
def test_design_of_every_k3_call(name, monkeypatch):
    """One eval forward of a pipeline at 2048 points: each K3 call's shape
    and the design the wrapper takes for it in either mode, and F's shapes."""
    from vn_pointcloudcompletion_tpu_torch.models.composer import build_model

    seen, fps_seen = {}, set()
    edge, fps = port_knn.edge_knn_gather, port_fps.furthest_point_sample_kernel

    def record_edge(xflat, u, v, k):
        shape = (xflat.shape[2], xflat.shape[1], u.shape[1], k)
        seen[shape] = {port_knn.edge_design(shape[0], shape[1], k, bf16) for bf16 in (False, True)}
        return edge(xflat, u, v, k)

    def record_fps(xyz, s):
        fps_seen.add((xyz.shape[1], s))
        return fps(xyz, s)

    monkeypatch.setattr(port_knn, "edge_knn_gather", record_edge)
    monkeypatch.setattr(port_fps, "furthest_point_sample_kernel", record_fps)
    enc, dec, nc, want = _K3_CALLS[name]
    model = build_model(Config.from_dict({"enc_type": enc, "dec_type": dec,
                                          "num_coarse": nc, "seed": 3})).eval()
    xyz = torch.from_numpy((np.random.default_rng(5).standard_normal((1, 2048, 3)) * 0.3)
                           .astype(np.float32))
    with torch.no_grad():
        model(xyz)
    assert seen == {shape: {design} for shape, design in want.items()}
    assert fps_seen == _F_CALLS[name]


@pytest.mark.parametrize("n,d,k,bf16,design", [
    (512, 3, 16, False, "coords"), (512, 3, 16, True, "coords"), (128, 3, 16, False, "coords"),
    (512, 4, 16, False, "coords"), (1024, 3, 16, True, "coords"), (64, 3, 32, False, "coords"),
    (512, 5, 16, False, "tiled"), (512, 96, 16, True, "tiled"), (512, 192, 16, False, "tiled"),
    (128, 192, 16, True, "tiled"), (128, 512, 16, False, "tiled"),
    (2048, 3, 16, False, "warp"), (1024, 3, 16, False, "warp"), (1024, 96, 16, True, "warp"),
    (512, 3, 32, False, "warp"), (512, 3, 64, False, "warp"), (300, 48, 32, False, "warp"),
    (333, 3, 32, True, "warp"), (116, 48, 16, False, "warp"), (120, 3, 16, True, "warp"),
])
def test_edge_design_boundary(n, d, k, bf16, design):
    """"coords" at D <= 4, "tiled" above at N <= 512 a multiple of 8, both
    where the gather fits (gather_slots) and k <= 32; "warp" elsewhere: N
    past 256 16-byte runs, k slots that do not split evenly over the
    threads, k > 32, N not whole runs (bf16 runs are 8 values)."""
    assert port_knn.edge_design(n, d, k, bf16) == design


@pytest.mark.parametrize("n,k,bf16,slots", [
    (512, 16, False, 8), (512, 16, True, 4), (128, 16, False, 2), (128, 16, True, 1),
    (1024, 16, False, 0), (1024, 16, True, 8), (256, 32, False, 8), (512, 32, False, 0),
    (116, 16, False, 2), (120, 16, True, 0), (600, 16, False, 0), (64, 8, False, 0),
])
def test_gather_slots(n, k, bf16, slots):
    """A gather thread owns one 16-byte run of queries and k / (256 / runs)
    consecutive slots (1, 2, 4 or 8; csrc knn.cu gather_kpt): so every
    (slot, run) pair of a row falls to exactly one thread."""
    assert port_knn.gather_slots(n, k, bf16) == slots
    if slots:
        runs = n // (8 if bf16 else 4)
        threads = (k // slots) * runs  # the threads that hold slots
        assert threads <= 256 and (k // slots) * slots == k


def test_fps_chain_probe_has_no_cpu_version():
    """F's dependency-floor probe launches the kernel without its
    arithmetic: no plain version, so a CPU tensor is refused."""
    with pytest.raises(ValueError, match="CUDA"):
        port_fps.furthest_point_sample_chain(torch.zeros(1, 64, 3), 8)


@pytest.mark.parametrize("n,d,c3", [(512, 192, 96), (128, 192, 192)])
def test_k3_plain_matches_pallas_on_features(n, d, c3):
    """K3's plain version against JAX's edge kernel in interpret mode over
    vn_pointr's D 192 features (N 512, conv5; N 128, conv6): indices equal
    (the features have a gap at the 16th neighbour far above float32
    rounding, ``_assert_knn_gap``: the two sides sum the distances in
    another order) and the gathered values equal."""
    rng = np.random.default_rng(n + d)
    # features of a 3-D cloud, as a VN layer's are of its points (512
    # independent Gaussian points in 192 dimensions leave some point's 16th
    # and 17th neighbours closer than 1e-5 of each other)
    x = np.einsum("ec,bcn->ben", rng.standard_normal((d, 3)),
                  rng.standard_normal((1, 3, n))).astype(np.float32)
    _assert_knn_gap(x.transpose(0, 2, 1), 16, 1e-5)
    u, v = (rng.standard_normal((1, c3, n)).astype(np.float32) for _ in range(2))
    want = jax_knn_pallas.edge_knn_gather(*map(jnp.asarray, (x, u, v)), 16, True)
    got, idx = port_knn.reference_edge_knn_gather(*map(torch.from_numpy, (x, u, v)), 16)
    assert got.shape == (1, c3, 16, n) and idx.shape == (1, n, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
