"""Command line of the PyTorch/CUDA port: ``predict`` and ``test``.

    python -m vn_pointcloudcompletion_tpu_torch -n <run> --resume predict -i <ply or dir> [-o <dir>] [--save]
    python -m vn_pointcloudcompletion_tpu_torch -n <run> --resume test [--save] [--novel]

``<run>`` is an experiment directory under ``$OUTPUT_DIR`` (default
``./experiments/``) holding ``config.json`` and ``models/model_best.pth`` (or
``model_last.pth``).  The flags are ``main.py``'s for these two commands,
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels).  Training comes with a later slice of the port.
"""

from __future__ import annotations

import argparse
import logging
import os


def main(argv=None):
    """Run one command; returns the written files (predict) or the metric
    table (test)."""
    parser = argparse.ArgumentParser("vn_pointcloudcompletion_tpu_torch")
    parser.add_argument("-n", "--name", type=str, default=None,
                        help="experiment dir name under $OUTPUT_DIR")
    parser.add_argument("--resume", action="store_true",
                        help="use the named experiment (required)")
    parser.add_argument("--save", action="store_true",
                        help="test: export predicted clouds as .ply; "
                             "predict: also write the coarse clouds")
    parser.add_argument("--emd", action="store_true",
                        help="test: also report per-point EMD (not ported yet)")
    parser.add_argument("--novel", action="store_true",
                        help="test: evaluate the 8 novel (unseen) categories")
    parser.add_argument("-i", "--input", type=str, default=None,
                        help="predict: a partial .ply file or a directory of them")
    parser.add_argument("-o", "--output", type=str, default=None,
                        help="predict: output directory (default <exp_dir>/predictions)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("command", choices=["test", "predict"])
    args = parser.parse_args(argv)

    if not args.resume or args.name is None:
        parser.error(f"{args.command} requires --resume with -n <existing experiment>")
    if args.command == "predict" and not args.input:
        parser.error("predict requires -i/--input <.ply file or directory>")

    from vn_pointcloudcompletion_tpu_torch.utils.config import load_config

    config = load_config(args.name)
    handler = logging.FileHandler(os.path.join(config.exp_dir, f"{args.command}.log"))
    handler.setFormatter(logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    log = logging.getLogger("test")
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        if args.command == "predict":
            from vn_pointcloudcompletion_tpu_torch.training.predict import predict

            out_dir = args.output or os.path.join(config.exp_dir, "predictions")
            written = predict(config, args.input, out_dir, save_coarse=args.save,
                              device=args.device)
            print(f"wrote {len(written)} completions -> {out_dir}")
            return written

        from vn_pointcloudcompletion_tpu_torch.data.shapenet import CATEGORIES_PCN_NOVEL
        from vn_pointcloudcompletion_tpu_torch.training.evaluate import evaluate

        categories = list(CATEGORIES_PCN_NOVEL) if args.novel else None
        return evaluate(config, save=args.save, categories=categories,
                        with_emd=args.emd, device=args.device)
    finally:
        log.removeHandler(handler)
        handler.close()


if __name__ == "__main__":
    main()
