"""Command line of the PyTorch/CUDA port: ``train``, ``overfit``, ``predict``
and ``test``.

    python -m vn_pointcloudcompletion_tpu_torch [-n <name>] [-epochs N] train
    python -m vn_pointcloudcompletion_tpu_torch -n <run> --resume [-epochs N] train
    python -m vn_pointcloudcompletion_tpu_torch [-n <name>] [-epochs N] overfit
    python -m vn_pointcloudcompletion_tpu_torch -n <run> -from <epoch|best|last> [-epochs N] train
    python -m vn_pointcloudcompletion_tpu_torch -n <run> --resume predict -i <ply or dir> [-o <dir>] [--save]
    python -m vn_pointcloudcompletion_tpu_torch -n <run> --resume test [--save] [--novel]
    python -m vn_pointcloudcompletion_tpu_torch [-n <name>] --mesh N train

A new ``train`` or ``overfit`` run reads ``config.json`` in the working
directory and creates ``$OUTPUT_DIR/MM-DD_<name>_NNN/`` (default
``./experiments/``) with ``config.json``, ``<command>.log``,
``metrics.jsonl``, ``models/model_{best,last}.pth``,
``optimizer/optim_{best,last}.pth`` and ``visualizations/epoch_NNN.png``
(one validation sample an epoch, where matplotlib is installed).  ``--resume`` continues the named run
from its ``last`` pair at the next epoch; ``-from N`` starts a new run
from the named run's snapshot and its numbered pair ``model_N``/``optim_N``
(written every ``checkpoint_every`` epochs; ``best`` and ``last`` too) at
epoch N + 1, and ``--resume`` takes precedence over it.  ``--ckpt_path``
loads a pretrained encoder (a ``.pth`` state dict, or a flax msgpack
``.ckpt`` of the JAX package) and freezes it.
``predict`` and ``test`` read the named run's ``model_best.pth`` (or
``model_last.pth``).  ``overfit`` trains and validates on ``batch_size``
synthetic samples.  ``--mesh N`` trains data-parallel on N cards of this
host, one process a card (``parallel/``; ``batch_size`` is the global
batch), ``--mesh 0`` on every visible card; with ``--device cpu`` it runs N
gloo processes.  The flags are ``main.py``'s, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain versions of the kernels).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    """Run one command; returns the training summary (train, overfit), the
    written files (predict) or the metric table (test)."""
    parser = argparse.ArgumentParser("vn_pointcloudcompletion_tpu_torch")
    parser.add_argument("-n", "--name", type=str, default=None,
                        help="experiment name (resume: experiment dir name)")
    parser.add_argument("--resume", action="store_true",
                        help="use (train: continue) the named experiment")
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="path of a pretrained encoder checkpoint (.pth, or a JAX "
                             "package .ckpt), loaded and frozen")
    parser.add_argument("-from", "--from_epoch", type=str, default=0,
                        help="branch a NEW run from -n <src run>'s numbered "
                             "checkpoint: an epoch, 'best' or 'last'")
    parser.add_argument("-epochs", "--epochs", type=int, default=None,
                        help="override max epochs")
    parser.add_argument("--mesh", type=int, default=None,
                        help="train/overfit only: data-parallel over N cards, one process "
                             "a card (0 = every visible card; default: one card, no "
                             "group); with --device cpu, N gloo processes")
    parser.add_argument("--save", action="store_true",
                        help="test: export predicted clouds as .ply; "
                             "predict: also write the coarse clouds")
    parser.add_argument("--emd", action="store_true",
                        help="test: also report per-point EMD")
    parser.add_argument("--novel", action="store_true",
                        help="test: evaluate the 8 novel (unseen) categories")
    parser.add_argument("-i", "--input", type=str, default=None,
                        help="predict: a partial .ply file or a directory of them")
    parser.add_argument("-o", "--output", type=str, default=None,
                        help="predict: output directory (default <exp_dir>/predictions)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("command", choices=["train", "overfit", "test", "predict"])
    args = parser.parse_args(argv)

    training = args.command in ("train", "overfit")
    if not training and (not args.resume or args.name is None):
        parser.error(f"{args.command} requires --resume with -n <existing experiment>")
    if args.resume and args.name is None:
        parser.error("--resume requires -n <experiment dir name>")
    # --resume takes precedence over -from (main.py:86-99)
    branching = not args.resume and args.from_epoch not in (0, "0", None, "")
    if branching and args.name is None:
        parser.error("-from requires -n <source experiment dir name>")
    if args.command == "predict" and not args.input:
        parser.error("predict requires -i/--input <.ply file or directory>")
    world = None
    if args.mesh is not None and not training:
        print(f"warning: --mesh applies to train/overfit only; {args.command} runs "
              "single-device", file=sys.stderr)
    elif args.mesh is not None:
        world = _mesh_size(parser, args.mesh, args.device)

    from vn_pointcloudcompletion_tpu_torch.utils.config import load_config, store_config
    from vn_pointcloudcompletion_tpu_torch.utils.experiments import (
        add_file_handler,
        configure_logging,
        create_experiment,
        remove_handler,
    )

    configure_logging()
    if args.resume:
        config = load_config(args.name)
    elif branching:
        # -from: a new run seeded from an existing run's numbered checkpoint
        # (reference main.py:40-46 + utils/experiments.py:154-166)
        config = load_config(args.name)  # the source run's snapshot (its exp_dir)
        fe = args.from_epoch
        config.checkpoint = int(fe) if str(fe).isdigit() else str(fe)
        config = create_experiment(config)
    else:
        config = load_config(None)
        if args.name:
            config.name = args.name
        config.checkpoint = 0
        config = create_experiment(config)
    if training:
        if args.epochs is not None:
            config.max_epochs = args.epochs
        if args.ckpt_path is not None:
            config.enc_pretrained = args.ckpt_path
        if args.command == "overfit":
            # one repeated batch, train and validation alike (main.py:137-144)
            config.overfit = True
            config.dataset = "synthetic"
            config.extra["synthetic_train_samples"] = config.batch_size
            config.extra["synthetic_val_samples"] = config.batch_size
        store_config(config)

    handler = add_file_handler(os.path.join(config.exp_dir, f"{args.command}.log"))
    try:
        if training:
            if world is not None:
                from vn_pointcloudcompletion_tpu_torch.parallel.train_parallel import (
                    train_on_ranks,
                )

                return train_on_ranks(config, args.resume, args.device, world,
                                      log_path=handler.baseFilename)
            from vn_pointcloudcompletion_tpu_torch.training.trainer import train

            return train(config, resume=args.resume, device=args.device)
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
        remove_handler(handler)


def _mesh_size(parser, mesh: int, device: str) -> int:
    """The ranks of ``--mesh``: N, or every visible card for 0; an error
    where the cards are fewer."""
    import torch

    if torch.device(device).type != "cuda":
        if mesh < 1:
            parser.error("--mesh 0 counts the visible cards; with --device cpu give the "
                         "number of processes")
        return mesh
    visible = torch.cuda.device_count()
    world = mesh or visible
    if mesh < 0 or not 1 <= world <= visible:
        parser.error(f"--mesh {mesh}: {visible} cards visible")
    return world


if __name__ == "__main__":
    main()
