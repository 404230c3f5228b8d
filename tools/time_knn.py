#!/usr/bin/env python3
"""Times of ``knn()`` on its kernel-K1 branch and of K1 alone on one card,
to compare two checkouts of the repository in one call (in the order
parent, change, change, parent):

    cd <checkout> && python3 <this repository>/tools/time_knn.py [reps]

It imports the port package and ``chip_smoke.py`` of the current directory,
so the same code times whichever commit is checked out there.  ``knn()`` at
(8, 2048 vs 2048, D 768, k 16) (a plane-layout VN EdgeConv's features at
C 256, past the fused kernel K2's D 512: the distance matrix, then K1) on
random features from seed 7, ``reps`` calls (default 10) after two warm-up
calls, CUDA events around each call with a synchronisation inside it
(``chip_smoke.cuda_ms``); then K1 alone over the (8, 2048, M) distance
matrices of the main path's rotated partial scans (``topk_min_fwd``, the
checkout's design): M 2048 at k 16, 40 and 64 and M 4096 at k 16, a call,
back to back (``chip_smoke.stream_ms``) and on the device
(``chip_smoke.graph_ms``).  The first line is the card's name and power
limit, the second one JSON object of medians in ms.  It builds the
checkout's kernels first, needs a CUDA card, and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_knn: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from vn_pointcloudcompletion_tpu_torch.ops import cuda_lib, knn_pallas
    from vn_pointcloudcompletion_tpu_torch.ops.knn import knn
    from vn_pointcloudcompletion_tpu_torch.ops.rotations import rotate_points
    from vn_pointcloudcompletion_tpu_torch.utils.device import resolve_device

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cuda_lib.build_all()
    dev = resolve_device("cuda")
    feats = torch.randn(8, 2048, 768, generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev)

    def knn_call():
        out = knn(feats, feats, 16)
        torch.cuda.synchronize()
        return out

    out = {"knn_d768_ms": cs.cuda_ms(knn_call, reps)}
    del feats
    partial, complete, rot = cs.main_path_batch(dev)
    q = rotate_points(partial, rot)
    mats = {2048: knn_pallas.pairwise_sqdist(q, q),
            4096: knn_pallas.pairwise_sqdist(q, rotate_points(complete[:, :4096], rot))}
    for m, k in ((2048, 16), (4096, 16), (2048, 40), (2048, 64)):
        d = mats[m]
        fn = lambda: knn_pallas.topk_min_fwd(d, k)  # noqa: E731
        out[f"k1_{m}_k{k}"] = {"ms": cs.cuda_ms(fn, 20), "stream_ms": cs.stream_ms(fn, 20),
                               "graph_ms": cs.graph_ms(fn)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
