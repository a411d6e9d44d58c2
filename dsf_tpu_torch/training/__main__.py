"""The trainer's command line: ``python -m dsf_tpu_torch.training [--key
value ...]`` (counterpart of dsf_tpu/training/__main__.py; ref: the
edit-the-file + ``python train_render.py`` flow, train_render.py:874-889).

Every ``Config`` field is an option (tuples as comma-separated values,
booleans as true/false).  With the default ``--phase train`` it trains on
the card (each epoch saves ``latest``, tests view 0 and keeps ``best``),
then evaluates the test set (NYU's three views); ``--phase test`` only
evaluates.  ``--dataset`` is nyu (the default), icvl, msra (with
``--test_id``, the left-out subject 0-8) or shrec; the data sits under
``{root_dir}/{dataset}``.

On N cards of one host: ``torchrun --nproc-per-node N -m
dsf_tpu_torch.training --key value ...``: one process a card, NCCL
between them, ``--batch_size`` the global batch (it must divide by N)
and ``--n_fsdp`` the ranks that share one copy of the parameters and
the optimizer state (ZeRO-3, ``parallel.fsdp``; it must divide N); see
``training.loop``.  A bare launch is one process on one
card (the JAX package's one process drives every local device instead).

``python -m dsf_tpu_torch.training cyclegan --key value ...`` trains the
CycleGAN transfer net on the card (``pipelines.run_cyclegan``) and writes
``{save_dir}/{dataset}/cyclegan_{run_name}/transfer_G_A.npz``, which
``--transferNet_pth`` then names.  ``python -m dsf_tpu_torch.training
ccssl --key value ...`` runs the CCSSL pipeline on the card
(``pipelines.run_ccssl``): pseudo labels for the NYU train split from
the net of ``--load_model`` (or the seeded one), then ``max_epoch``
epochs on them, into ``{save_dir}/{dataset}/ccssl_{run_name}``; it runs
in one process.
"""

from __future__ import annotations

import argparse
import dataclasses


def parse_config(argv=None, description="dsf_tpu_torch trainer"):
    """A ``Config`` from ``--field value`` options."""
    from dsf_tpu_torch.config import Config
    parser = argparse.ArgumentParser(description=description)
    for f in dataclasses.fields(Config):
        if f.type in ("bool", bool):
            parser.add_argument(f"--{f.name}", type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=f.default)
        elif isinstance(f.default, tuple):
            parser.add_argument(f"--{f.name}", type=str,
                                default=",".join(map(str, f.default)))
        else:
            parser.add_argument(f"--{f.name}", type=type(f.default),
                                default=f.default)
    args = vars(parser.parse_args(argv))
    for f in dataclasses.fields(Config):
        if isinstance(f.default, tuple) and isinstance(args[f.name], str):
            cast = str if isinstance(f.default[0], str) else float
            args[f.name] = tuple(cast(e) for e in args[f.name].split(","))
    return Config(**args)


def main(argv=None):
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    # subcommands for the auxiliary pipelines; default = the main trainer
    if argv and argv[0] in ("ccssl", "cyclegan"):
        sub, rest = argv[0], argv[1:]
        cfg = parse_config(rest, description=f"dsf_tpu_torch {sub} pipeline")
        import logging
        logging.basicConfig(level=logging.INFO)
        from dsf_tpu_torch.training import pipelines
        if sub == "ccssl":
            pipelines.run_ccssl(cfg)
        else:
            pipelines.run_cyclegan(cfg)
        return
    from dsf_tpu_torch.training.loop import run
    run(parse_config(argv))


if __name__ == "__main__":
    main()
