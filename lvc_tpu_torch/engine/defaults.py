"""Argument parser and process setup of the port's CLIs.

Counterpart of ``default_argument_parser`` and ``default_setup`` of
``lvc_tpu/engine/defaults.py`` (:48-88): the same flags, the same logging,
config dump and numpy seeding, with the torch device logged in place of the
jax devices. The distributed flags are accepted for compatibility; the
port's CLIs run in one process.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch

logger = logging.getLogger("lvc_tpu_torch")


def default_argument_parser():
    """Same flags as the reference (lvc/engine/defaults.py:63-145)."""
    parser = argparse.ArgumentParser(description="LVC (PyTorch/CUDA port)")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--eval-all", action="store_true")
    parser.add_argument("--eval-during-train", action="store_true")
    parser.add_argument("--eval-iter", type=int, default=-1)
    parser.add_argument("--start-iter", type=int, default=-1)
    parser.add_argument("--end-iter", type=int, default=-1)
    parser.add_argument("--num-gpus", type=int, default=1, help="(compat) ignored; one process")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0)
    parser.add_argument("--dist-url", default="auto")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def default_setup(cfg, args):
    """Logging, the config dump into ``OUTPUT_DIR`` and the numpy seed
    (``SEED``, or a random one when negative). Returns the seed."""
    output_dir = cfg.OUTPUT_DIR
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        stream=sys.stdout,
        force=False,
    )
    logger.info("Command line args: %s", args)
    if cfg.MODEL.DEVICE == "cuda" and torch.cuda.is_available():
        logger.info("Device: cuda (%s)", torch.cuda.get_device_name(0))
    else:
        logger.info("Device: %s", cfg.MODEL.DEVICE)
    if output_dir:
        path = os.path.join(output_dir, "config.yaml")
        with open(path, "w") as f:
            f.write(cfg.dump())
        logger.info("Full config saved to %s", path)
    seed = cfg.SEED if cfg.SEED >= 0 else int.from_bytes(os.urandom(4), "little")
    np.random.seed(seed)
    return seed
