"""Weights: JAX parameter trees to the reference's PyTorch state dict.

``from_jax_variables`` is the port's copy of
``zero_tig_tpu/core/checkpoint.py::export_torch_state_dict`` (:211-301): it
turns the JAX package's parameter trees (numpy arrays, HWIO kernels) into
the reference's key names and OIHW weights, with the ``enhance.blocks.{0,1,2}``
aliases of the shared block and both names of each RAFT ``norm3``. A real
reference ``.pt`` has the same keys, so it loads with ``load_state_dict``.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch


def _conv_back(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).transpose(3, 2, 0, 1))


def from_jax_variables(net_vars: dict, raft_vars: dict | None = None) -> dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} trees (numpy leaves) -> reference state dict."""
    out: dict[str, np.ndarray] = {}
    p = net_vars["params"]
    s = net_vars.get("batch_stats", {})
    enh = p["enhance"]
    out["enhance.in_conv.0.weight"] = _conv_back(enh["in_conv"]["kernel"])
    out["enhance.in_conv.0.bias"] = np.asarray(enh["in_conv"]["bias"])
    shared = {
        "0.weight": _conv_back(enh["block"]["conv"]["kernel"]),
        "0.bias": np.asarray(enh["block"]["conv"]["bias"]),
        "1.weight": np.asarray(enh["block"]["bn"]["scale"]),
        "1.bias": np.asarray(enh["block"]["bn"]["bias"]),
        "1.running_mean": np.asarray(s["enhance"]["block"]["bn"]["mean"]),
        "1.running_var": np.asarray(s["enhance"]["block"]["bn"]["var"]),
        "1.num_batches_tracked": np.asarray(0),
    }
    for alias in ["conv"] + [f"blocks.{i}" for i in range(3)]:
        for k, v in shared.items():
            out[f"enhance.{alias}.{k}"] = v
    out["enhance.out_conv.0.weight"] = _conv_back(enh["out_conv"]["kernel"])
    out["enhance.out_conv.0.bias"] = np.asarray(enh["out_conv"]["bias"])
    for dn in ("denoise_1", "denoise_2"):
        for cv in ("conv1", "conv2", "conv3"):
            out[f"{dn}.{cv}.weight"] = _conv_back(p[dn][cv]["kernel"])
            out[f"{dn}.{cv}.bias"] = np.asarray(p[dn][cv]["bias"])
    if raft_vars is not None:
        _raft(out, raft_vars)
    return {k: torch.as_tensor(np.array(v, copy=True)) for k, v in out.items()}


def from_jax_raft_variables(raft_vars: dict) -> dict[str, torch.Tensor]:
    """A RAFT {'params', 'batch_stats'} tree, or a part of one (one block),
    -> its 'raft.*' state-dict entries."""
    out: dict[str, np.ndarray] = {}
    _raft(out, raft_vars)
    return {k: torch.as_tensor(np.array(v, copy=True)) for k, v in out.items()}


def _raft(out: dict, raft_vars: dict) -> None:
    def walk(tree: Any, path: tuple[str, ...], collection: str) -> None:
        for name, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub, (*path, name), collection)
                continue
            key = raft_path_to_torch((*path, name), collection)
            arr = np.asarray(sub)
            if key.endswith("weight") and arr.ndim == 4:
                arr = _conv_back(arr)
            out["raft." + key] = arr
            # the reference registers a strided block's norm3 twice, as
            # .norm3 and as .downsample.1 (extractor.py:25,43-44)
            if ".downsample.1." in key:
                out["raft." + key.replace(".downsample.1.", ".norm3.")] = arr

    walk(raft_vars["params"], (), "params")
    walk(raft_vars.get("batch_stats", {}), (), "batch_stats")


def raft_path_to_torch(path: tuple[str, ...], collection: str) -> str:
    """A JAX RAFT parameter path -> the reference's key (without 'raft.').

    Copy of zero_tig_tpu/core/checkpoint.py::_our_raft_path_to_torch (:278)."""
    parts = list(path)
    leaf = parts.pop()
    leaf_map = (
        {"kernel": "weight", "bias": "bias", "scale": "weight"}
        if collection == "params"
        else {"mean": "running_mean", "var": "running_var"}
    )
    segs: list[str] = []
    for part in parts:
        if part == "bn":
            continue
        m = re.match(r"^layer(\d)_(\d)$", part)
        if m:
            segs.append(f"layer{m.group(1)}.{m.group(2)}")
        elif part == "downsample":
            segs.append("downsample.0")
        elif part == "norm3" and segs and segs[-1].startswith("layer"):
            segs.append("downsample.1")  # norm3 sits in the downsample Sequential
        elif re.match(r"^mask_(\d)$", part):
            segs.append("mask." + part.split("_")[1])
        else:
            segs.append(part)
    return ".".join(segs) + "." + leaf_map[leaf]
