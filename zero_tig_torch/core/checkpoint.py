"""Weights: ``.pt`` checkpoints, and JAX parameter trees to the reference's
PyTorch state dict.

``from_jax_variables`` is the port's copy of
``zero_tig_tpu/core/checkpoint.py::export_torch_state_dict`` (:211-301): it
turns the JAX package's parameter trees (numpy arrays, HWIO kernels) into
the reference's key names and OIHW weights, with the ``enhance.blocks.{0,1,2}``
aliases of the shared block and both names of each RAFT ``norm3``. A real
reference ``.pt`` has the same keys, so it loads with ``load_state_dict``.

``load_checkpoint`` / ``save_pt`` / ``merge`` are the ``.pt`` side of
``load_torch_checkpoint`` (:201-209), ``save_torch_pt`` (:317-325) and
``cli/common.py::_merge`` (:114-125): the ``.pt`` is the interchange format
both packages read and write (the JAX package's ``.msgpack`` twins are
flax's format and have no counterpart here).
"""

from __future__ import annotations

import os
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


_NET_PREFIXES = ("enhance.", "denoise_1.", "denoise_2.")
_RAFT_NETS = ("fnet.", "cnet.", "update_block.")


def load_checkpoint(path: str | os.PathLike) -> tuple[dict | None, dict | None]:
    """A reference, JAX-exported or port ``.pt`` -> (network entries, ``raft.*``
    entries), each None where the file holds none. Unwraps a ``"state_dict"``
    wrapper and DataParallel's ``module.`` prefix; a RAFT-only file (keys
    ``fnet.*``, ``cnet.*``, ``update_block.*``, as ``raft-sintel.pth``) gets the
    ``raft.`` prefix; other keys are dropped (key-intersection semantics)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    net: dict = {}
    raft: dict = {}
    for key, value in sd.items():
        k = key.removeprefix("module.")
        if k.startswith(_NET_PREFIXES):
            net[k] = value
        elif k.startswith("raft."):
            raft[k] = value
        elif k.startswith(_RAFT_NETS):
            raft["raft." + k] = value
    return net or None, raft or None


def state_dict_for_save(model) -> dict:
    """``model``'s weights under the keys ``from_jax_variables`` produces, on
    the CPU: the reference's names with every alias, RAFT's BatchNorm step
    counters left out (the JAX export has none)."""
    return {
        k: v.detach().cpu().clone()
        for k, v in model.state_dict().items()
        if not (k.startswith("raft.") and k.endswith("num_batches_tracked"))
    }


def save_pt(path: str | os.PathLike, model) -> None:
    """Write ``model``'s weights as a reference-loadable ``.pt``."""
    torch.save(state_dict_for_save(model), path)


def merge(base: dict, override: dict | None) -> dict:
    """``base`` with every key it shares with ``override`` taken from
    ``override``; keys only in ``override`` are ignored (the reference's
    partial-load semantics, cli/common.py:114-125). The aliases then follow
    the names the JAX package reads: ``enhance.conv.*`` for the shared
    Enhancer block, ``downsample.1`` for a RAFT ``norm3``."""
    if not override:
        return dict(base)
    out = {k: (override[k] if k in override else v) for k, v in base.items()}
    for k in out:
        m = re.match(r"^enhance\.blocks\.\d+\.(.*)$", k)
        src = "enhance.conv." + m.group(1) if m else k.replace(".norm3.", ".downsample.1.")
        if src != k and src in out:
            out[k] = out[src]
    return out
