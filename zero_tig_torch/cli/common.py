"""Shared CLI plumbing: logging, experiment directories, weights, PNG output.

Port of ``zero_tig_tpu/cli/common.py`` (:1-142). ``load_state_dict`` is its
``load_variables`` on the reference's state-dict keys; ``write_png`` goes
through the port's PNG codec (``native``), not OpenCV.
"""

from __future__ import annotations

import glob
import logging
import os
import shutil
import sys
import time

import numpy as np
import torch

from .. import native
from ..core.checkpoint import load_checkpoint, merge
from ..core.config import Config
from ..models import init_state_dict
from ..utils.misc import count_parameters_in_mb  # noqa: F401  (the train CLI's model size line)


def setup_logging(save_dir: str) -> logging.Logger:
    """stdout + <save>/log.txt, reference format (train.py:38-43)."""
    os.makedirs(save_dir, exist_ok=True)
    fmt = "%(asctime)s %(message)s"
    logging.basicConfig(
        stream=sys.stdout, level=logging.INFO, format=fmt,
        datefmt="%m/%d %I:%M:%S %p", force=True,
    )
    fh = logging.FileHandler(os.path.join(save_dir, "log.txt"))
    fh.setFormatter(logging.Formatter(fmt))
    logging.getLogger().addHandler(fh)
    return logging.getLogger()


def create_exp_dir(base: str) -> str:
    """Timestamped Train-* dir with a snapshot of the CLI sources
    (train.py:33-34, utils/utils.py:109-118)."""
    path = os.path.join(base, "Train-{}".format(time.strftime("%Y%m%d-%H%M%S")))
    os.makedirs(path, exist_ok=True)
    sdir = os.path.join(path, "scripts")
    os.makedirs(sdir, exist_ok=True)
    for script in glob.glob(os.path.join(os.path.dirname(__file__), "*.py")):
        shutil.copyfile(script, os.path.join(sdir, os.path.basename(script)))
    return path


def load_state_dict(config: Config, *, for_training: bool = False, strict_raft: bool = False) -> dict:
    """The run's weights (reference key names, CPU tensors), in the JAX
    package's order (:59-115): fresh weights (``init_state_dict``, with the
    reference's Enhancer re-init for training), then the ``model_pretrain``
    checkpoint over them, then ``raft_weights`` over RAFT. Unlike the
    reference Finetunemodel, which silently runs a random RAFT, missing RAFT
    weights are logged loudly; ``strict_raft`` makes them an error."""
    log = logging.getLogger()
    sd = init_state_dict(config.seed, for_training=for_training)
    raft_loaded = False

    if config.model_pretrain and os.path.exists(config.model_pretrain):
        net_ckpt, raft_ckpt = load_checkpoint(config.model_pretrain)
        if net_ckpt is not None:
            sd = merge(sd, net_ckpt)
            log.info("Loaded pre-trained model from %s.", config.model_pretrain)
        if raft_ckpt is not None:
            sd = merge(sd, raft_ckpt)
            raft_loaded = True
    elif config.model_pretrain:
        log.info("Model is initialized without pre-trained model.")

    if config.raft_weights and os.path.exists(config.raft_weights):
        _, raft_ckpt = load_checkpoint(config.raft_weights)
        if raft_ckpt is not None:
            sd = merge(sd, raft_ckpt)
            raft_loaded = True

    if not raft_loaded:
        msg = (
            "RAFT weights not loaded -- flow runs with random init "
            "(the reference Finetunemodel has the same failure mode, "
            "model/model.py:272-286). Pass --raft_weights to fix."
        )
        if strict_raft:
            raise FileNotFoundError(msg)
        log.warning(msg)
    return sd


def save_images_uint8(img01) -> np.ndarray:
    """float [0,1] (H, W, 3) -> uint8, reference clipping (train.py:58-62).

    uint8 input passes through untouched (``predict_chunk(emit="u8")``
    applies the same formula on the device)."""
    a = img01.detach().cpu().numpy() if torch.is_tensor(img01) else np.asarray(img01)
    if a.dtype == np.uint8:
        return a
    return np.clip(a * 255.0, 0, 255.0).astype("uint8")


def write_png(path: str, img01) -> None:
    native.write_png(path, save_images_uint8(img01))
