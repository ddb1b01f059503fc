"""Multi-dataset orchestration: ``python -m zero_tig_torch.cli.run_pipeline``.

Port of ``zero_tig_tpu/cli/run_pipeline.py`` (:1-112; reference
run_pipeline.py:110-169). For each dataset: train, find the newest Train-*
run, evaluate its last epoch's weights, and print the metrics table as
JSON. In one process; a dataset that fails is reported and skipped, as in
the reference.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import traceback

from ..core.config import Config
from ..core.device import resolve_device
from .evals import run_evals
from .train import run_training

# dataset-name -> loader type map (run_pipeline.py:10-21)
DATASET_TYPES = {
    "RLV": "RLV",
    "BVI-RLV": "RLV",
    "lowlight_dataset": "RLV",
    "DID": "DID",
    "DID_1080": "DID",
    "SDSD": "SDSD",
    "3_SDSD": "SDSD",
    "underwater": "underwater",
}


def find_latest_run_dir(base: str) -> str | None:
    runs = sorted(glob.glob(os.path.join(base, "Train-*")))
    return runs[-1] if runs else None


def run_dataset(
    dataset: str,
    base_data_dir: str,
    *,
    epochs: int = 5,
    model_pretrain: str | None = None,
    raft_weights: str | None = None,
    save_root: str = "./EXP",
    lpips_weights: str | None = None,
    device=None,
    **config_overrides,
) -> dict | None:
    """Train on ``<base_data_dir>/<dataset>``, then evaluate the last epoch."""
    data_dir = os.path.join(base_data_dir, dataset)
    cfg = Config(
        dataset=dataset,
        lowlight_images_path=data_dir,
        epochs=epochs,
        model_pretrain=model_pretrain,
        raft_weights=raft_weights,
        save=os.path.join(save_root, dataset),
        **config_overrides,
    )
    run_dir = run_training(cfg, device=device)

    weights = os.path.join(run_dir, "model_epochs", f"weights_{epochs - 1}.pt")
    eval_cfg = Config(
        dataset=dataset,
        lowlight_images_path=data_dir,
        model_pretrain=weights,
        raft_weights=raft_weights,
        save=os.path.join(run_dir, "results"),
        **config_overrides,
    )
    return run_evals(eval_cfg, lpips_weights=lpips_weights, device=device)


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser("ZERO-TIG pipeline")
    parser.add_argument("--datasets", nargs="+", required=True)
    parser.add_argument("--base_data_dir", type=str, required=True)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--model_pretrain", type=str, default=None)
    parser.add_argument("--raft_weights", type=str, default=None)
    parser.add_argument("--save_root", type=str, default="./EXP")
    parser.add_argument("--lpips_weights", type=str, default=None)
    args = parser.parse_args(argv)
    device = resolve_device(device)

    results = {}
    for ds in args.datasets:
        try:
            results[ds] = run_dataset(
                ds, args.base_data_dir,
                epochs=args.epochs,
                model_pretrain=args.model_pretrain,
                raft_weights=args.raft_weights,
                save_root=args.save_root,
                lpips_weights=args.lpips_weights,
                device=device,
            )
        except Exception:  # a boundary: report the dataset and go on to the next
            print(f"[run_pipeline] dataset {ds} FAILED:")
            traceback.print_exc()
            results[ds] = None
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
