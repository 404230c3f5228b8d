"""The plain reference against the port's plain path on the CPU, at small
sizes: the vn_pointr_448 pipeline layer group by layer group, from the
same inputs (a VN max pool's argmax amplifies rounding, so each group is
fed the reference's own input)."""

import torch

from port_bench import weights
from port_bench.modes.train import build_model
from port_bench.reference import vn_pointr as ref
from port_bench.tests._tiny import CPU

CONFIG = {"num_coarse": 448, "reference": "vn_pointr", "enc_type": "vn_pointr",
          "dec_type": "attention_vn_foldingnet"}


def rel(a, b):
    return float((a - b).norm() / b.norm())


def test_vn_pointr_groups_match_the_port():
    from vn_pointcloudcompletion_tpu_torch.models.pointr import _seq, to_scalar, to_vn

    w = weights.make(ref.param_spec(CONFIG), 11, CPU)
    model = build_model(CONFIG, w, CPU)
    torch.manual_seed(0)
    xyz = torch.rand(2, 600, 3) - 0.5
    for train in (False, True):
        model.train(train)
        enc = model.encoder
        with torch.no_grad():
            coor, f = ref.grouper(w, xyz, train)
            got_coor, got_f = enc.grouper(xyz)
            assert torch.equal(got_coor, coor) and rel(got_f, f) < 1e-5
            x = to_scalar(_seq(enc.vn_input_proj, f))
            pts = coor.transpose(1, 2)
            idx = ref.knn_indices(pts, pts, ref.PROXY_K)
            for i, block in enumerate(enc.encoder):
                k = idx if i == 0 else None
                want = ref.to_scalar(ref.block(w, f"encoder.encoder.{i}", ref.to_vn(x), train,
                                               ref.HEADS, (ref.EMBED // ref.HEADS) ** -0.5, k))
                assert rel(to_scalar(block(to_vn(x), k)), want) < 1e-5
                x = want
            coarse, _, glob = ref.encode(w, xyz, train)
            assert rel(model.decoder(coarse, glob, None), ref.decode(w, coarse, glob, train)) < 1e-5
