"""Streaming inference CLI: ``python -m zero_tig_torch.cli.predict``.

Port of ``zero_tig_tpu/cli/predict.py`` (:1-129; reference predict.py, the
same flags and layout). Saves per frame
<save>/<scene>/<brightness>/<name>_{denoise,enhance}.png for RLV, and
<save>/<scene-dir>/<parent-dir>/... otherwise (predict.py:91-104). Full
chunks of ``--chunk`` frames run ``predict_chunk(emit="u8")``, the trailing
frames ``predict_step``. Unlike the JAX CLI, ``--precision`` is honoured.
"""

from __future__ import annotations

import argparse
import logging
import os

from ..core.config import Config, add_config_args, config_from_args
from ..core.device import resolve_device
from ..data import create_dataset
from ..data.prefetch import ChunkRecord, chunk_prefetch
from ..models import build_model
from ..pipeline.steps import init_carry, predict_chunk, predict_step
from .common import load_state_dict, setup_logging, write_png


def _save_frame(config: Config, rec, H2, H3) -> None:
    """Write one frame's two PNGs; H2 / H3 (1, H, W, 3), uint8 or float."""
    if config.dataset in ("RLV", "BVI-RLV", "lowlight_dataset"):
        splits = rec.path.split(os.sep)
        save_dir = os.path.join(config.save, splits[-3], splits[-2])
    else:
        # the reference keys on the immediate parent dir only (predict.py:99),
        # which collides across scenes sharing a subfolder name; the scene
        # dir is included as well
        parent = os.path.dirname(rec.path)
        save_dir = os.path.join(config.save, os.path.basename(os.path.dirname(parent)), os.path.basename(parent))
    os.makedirs(save_dir, exist_ok=True)
    write_png(os.path.join(save_dir, rec.name + "_denoise.png"), H3[0])
    write_png(os.path.join(save_dir, rec.name + "_enhance.png"), H2[0])


def run_predict(config: Config, *, device=None) -> None:
    """Enhance every test frame of ``config``'s dataset. ``device`` None
    means the card (and raises without one)."""
    device = resolve_device(device)
    setup_logging(config.save)
    log = logging.getLogger()
    log.info("Model path = %s", str(config.model_pretrain))

    model = build_model(load_state_dict(config), device=device, precision=config.precision)
    size = (config.frame_width, config.frame_height)
    test_ds = create_dataset(config.dataset, config.lowlight_images_path, "test", size=size)
    print("Total image number: ", str(len(test_ds)))

    step_kwargs = dict(of_scale=config.of_scale, raft_iters=config.raft_iters, enh_scale=config.enh_scale)
    carry = None
    for item in chunk_prefetch(test_ds.iter_u8(), config.chunk, depth=config.prefetch_depth, device=device):
        if isinstance(item, ChunkRecord):
            if carry is None:
                carry = init_carry(model, tuple(item.images.shape[1:]))
            for rec in item.records:
                if rec.is_new_seq:
                    print("Eval Get this img from: ", rec.path)
            (H2s, H3s), carry = predict_chunk(model, item.images, carry, item.flags, emit="u8", **step_kwargs)
            H2s, H3s = H2s.cpu().numpy(), H3s.cpu().numpy()  # one copy to the host per chunk
            for i, rec in enumerate(item.records):
                _save_frame(config, rec, H2s[i], H3s[i])
            continue
        rec = item
        if carry is None:
            carry = init_carry(model, tuple(rec.image.shape))
        if rec.is_new_seq:
            print("Eval Get this img from: ", rec.path)
        (H2, H3, _s3), carry = predict_step(model, rec.image, carry, rec.is_new_seq, **step_kwargs)
        _save_frame(config, rec, H2, H3)


def main(argv=None):
    parser = argparse.ArgumentParser("ZERO-TIG")
    add_config_args(parser)
    run_predict(config_from_args(parser.parse_args(argv)))


if __name__ == "__main__":
    main()
