"""The port's weights and training state on disk, its fresh weights and its
flags, against the JAX package's, on the CPU: ``.pt`` files written by
either package load in the other exactly, the partial-load merge and the
RAFT override behave as JAX's, a saved training state resumes to the
values of an uninterrupted run, ``init_state_dict`` draws from the JAX
init's distributions, and the same command line parses to the same Config."""

import argparse
import dataclasses
import functools
import json
import logging
import math
import os

import jax
import numpy as np
import pytest
import torch

from zero_tig_tpu.cli.common import _merge as jax_merge
from zero_tig_tpu.core import config as jconfig
from zero_tig_tpu.core.checkpoint import convert_torch_state_dict, export_torch_state_dict, load_torch_checkpoint
from zero_tig_tpu.core.checkpoint import save_torch_pt as jax_save_pt
from zero_tig_tpu.models.network import init_network_variables
from zero_tig_tpu.models.raft.raft import init_raft_variables
from zero_tig_torch.cli.common import count_parameters_in_mb, load_state_dict
from zero_tig_torch.core import config as tconfig
from zero_tig_torch.core.checkpoint import from_jax_variables, load_checkpoint, merge, save_pt, state_dict_for_save
from zero_tig_torch.core.train_ckpt import latest_checkpoint, restore_train_state, save_train_state
from zero_tig_torch.models import build_model, init_random_state_dict, init_state_dict
from zero_tig_torch.pipeline.steps import init_train_state, train_chunk

# Under pytest-xdist the workers share the host's cores with JAX's compiles:
# one intra-op thread each spends no CPU time waiting on the others.
torch.set_num_threads(1)

H, W = 48, 64
KW = dict(of_scale=2, raft_iters=2)


@pytest.fixture(scope="module")
def trees():
    """JAX variable trees of the real structure, shapes from tracing alone,
    values drawn with numpy: the conversions move values, they do not read them."""
    rng = np.random.default_rng(0)

    def drawn(init, key):
        tree = jax.eval_shape(functools.partial(init, h=16, w=16), key)
        return jax.tree_util.tree_map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(a.dtype), tree)

    return drawn(init_network_variables, jax.random.PRNGKey(0)), drawn(init_raft_variables, jax.random.PRNGKey(1))


def _assert_trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=jax.tree_util.keystr(path))


def test_jax_pt_loads_in_the_port(trees, tmp_path):
    nv, rv = trees
    jax_save_pt(str(tmp_path / "jax.pt"), nv, rv)
    net, raft = load_checkpoint(tmp_path / "jax.pt")
    want = from_jax_variables(nv, rv)
    assert set(net) | set(raft) == set(want) and all(k.startswith("raft.") for k in raft)
    for k, v in {**net, **raft}.items():
        assert torch.equal(v, want[k]), k
    # a RAFT-only file under DataParallel's prefix, as raft-sintel.pth
    torch.save({"state_dict": {"module." + k[len("raft."):]: v for k, v in raft.items()}}, tmp_path / "r.pth")
    net2, raft2 = load_checkpoint(tmp_path / "r.pth")
    assert net2 is None and set(raft2) == set(raft)


def test_port_pt_loads_in_jax(trees, tmp_path):
    nv, rv = trees
    model = build_model(from_jax_variables(nv, rv), device="cpu", precision="highest")
    assert set(state_dict_for_save(model)) == set(from_jax_variables(nv, rv))
    save_pt(tmp_path / "port.pt", model)
    got_nv, got_rv = load_torch_checkpoint(str(tmp_path / "port.pt"))
    _assert_trees_equal(got_nv, nv)
    _assert_trees_equal(got_rv, rv)


def test_merge_matches_jax(trees):
    # a partial checkpoint: Denoise_1, the shared Enhancer block under its
    # canonical name only, one RAFT encoder block, and an unknown key
    nv, rv = trees
    base = from_jax_variables(nv, rv)
    rng = np.random.default_rng(1)
    partial = {
        k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in base.items()
        if k.startswith(("denoise_1.", "enhance.conv.0.", "raft.cnet.layer2.0."))
        and not k.endswith("num_batches_tracked")
    }
    for k in [k for k in partial if ".downsample.1." in k]:  # one module under two names, as in any real file
        partial[k.replace(".downsample.1.", ".norm3.")] = partial[k]
    partial["not.a.key"] = torch.zeros(3)
    jnet, jraft = convert_torch_state_dict(partial)
    want = export_torch_state_dict(jax_merge(nv, jnet), jax_merge(rv, jraft))
    net, raft = ({k: v for k, v in partial.items() if k.startswith(p)} for p in (("enhance", "denoise"), "raft."))
    got = merge(merge(base, net), raft)
    assert set(got) == set(base)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    assert torch.equal(got["enhance.blocks.2.0.weight"], partial["enhance.conv.0.weight"])
    assert torch.equal(got["raft.cnet.layer2.0.norm3.weight"], partial["raft.cnet.layer2.0.downsample.1.weight"])


def test_raft_override_and_warning(tmp_path, caplog):
    # the JAX order: fresh weights, model_pretrain over them, raft_weights
    # over RAFT; the warning iff no RAFT weights were loaded
    full = init_random_state_dict(3)
    torch.save(full, tmp_path / "full.pt")
    torch.save({k: v for k, v in full.items() if not k.startswith("raft.")}, tmp_path / "net.pt")
    other = init_random_state_dict(4)
    torch.save({"module." + k[5:]: v for k, v in other.items() if k.startswith("raft.")}, tmp_path / "raft.pth")
    key_net, key_raft = "denoise_2.conv1.weight", "raft.fnet.conv1.weight"
    warned = "RAFT weights not loaded"
    cases = [
        (dict(), init_state_dict(2), init_state_dict(2), True),
        (dict(model_pretrain=str(tmp_path / "full.pt")), full, full, False),
        (dict(model_pretrain=str(tmp_path / "net.pt")), full, init_state_dict(2), True),
        (dict(model_pretrain=str(tmp_path / "full.pt"), raft_weights=str(tmp_path / "raft.pth")), full, other, False),
        (dict(model_pretrain=str(tmp_path / "missing.pt")), init_state_dict(2), init_state_dict(2), True),
    ]
    for kwargs, net_from, raft_from, warns in cases:
        caplog.clear()
        with caplog.at_level(logging.INFO):
            sd = load_state_dict(tconfig.Config(**kwargs))
        assert torch.equal(sd[key_net], net_from[key_net]) and torch.equal(sd[key_raft], raft_from[key_raft]), kwargs
        assert (warned in caplog.text) == warns, kwargs
        if warns:
            with pytest.raises(FileNotFoundError, match=warned):
                load_state_dict(tconfig.Config(**kwargs), strict_raft=True)
    assert "initialized without pre-trained model" in caplog.text


def test_init_state_dict_follows_the_jax_init():
    # torch's Conv2d default (JAX models/layers.py:26-39): U(+-1/sqrt(fan_in))
    # for weights and biases; BatchNorm at identity; for training the
    # Enhancer re-drawn N(0, 0.02) / zeros / N(1, 0.02); RAFT on its own stream
    sd = init_state_dict(7)
    sd_train = init_state_dict(7, for_training=True)
    model = build_model(sd, device="cpu", precision="highest")
    for name, module in model.named_modules():
        if isinstance(module, torch.nn.Conv2d):
            bound = 1.0 / math.sqrt(module.weight[0].numel())
            for t in (module.weight, module.bias):
                assert float(t.abs().max()) <= bound, name
                if t.numel() >= 4096:
                    assert abs(float(t.std()) / (bound / math.sqrt(3)) - 1) <= 0.05, name
        elif isinstance(module, torch.nn.BatchNorm2d):
            assert torch.equal(module.weight, torch.ones_like(module.weight)), name
            assert not module.bias.any() and not module.running_mean.any(), name
            assert torch.equal(module.running_var, torch.ones_like(module.running_var)), name
    enh = {k: v for k, v in sd_train.items() if k.startswith("enhance.")}
    for k, v in enh.items():
        if k.endswith("0.weight"):
            assert v.numel() < 4096 or abs(float(v.std()) / 0.02 - 1) <= 0.05, k
        elif k.endswith("0.bias") or k.endswith("1.bias"):
            assert not v.any(), k
        elif k.endswith("1.weight"):
            assert float((v - 1).abs().max()) <= 0.02 * 5, k
    assert all(torch.equal(sd[k], sd_train[k]) for k in sd if not k.startswith("enhance."))
    again = init_state_dict(7)
    assert all(torch.equal(v, again[k]) for k, v in sd.items())
    assert not torch.equal(sd["raft.fnet.conv1.weight"], init_state_dict(8)["raft.fnet.conv1.weight"])


def test_model_size_reads_as_jax(trees):
    nv, rv = trees
    jax_mb = sum(np.prod(x.shape) for x in jax.tree_util.tree_leaves({"net": nv["params"], "raft": rv["params"]})) / 1e6
    model = build_model(init_state_dict(0), device="cpu", precision="highest")
    assert count_parameters_in_mb(model) == jax_mb == 5.350156


def test_train_state_resumes_exactly(tmp_path):
    # 2 steps, save, restore into a fresh state, 2 more == 4 steps at once
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 0.3, (4, 1, H, W, 3)).astype(np.float32)
    flags = np.array([True, False, False, True])
    sd = init_state_dict(2, for_training=True)
    cfg = tconfig.Config(precision="highest", **KW)
    whole, losses = train_chunk(init_train_state(cfg, sd, (1, H, W, 3), device="cpu"), frames, flags, **KW)

    first, l1 = train_chunk(init_train_state(cfg, sd, (1, H, W, 3), device="cpu"), frames[:2], flags[:2], **KW)
    path = str(tmp_path / "state_0.pt")
    save_train_state(path, first, epoch=0, step=2, extra={"note": "x"})
    assert not os.path.exists(path + ".tmp")
    resumed, meta = restore_train_state(path, init_train_state(cfg, sd, (1, H, W, 3), device="cpu"))
    assert meta == {"epoch": 0, "step": 2, "note": "x"}
    resumed, l2 = train_chunk(resumed, frames[2:], flags[2:], **KW)

    assert torch.equal(torch.cat([l1, l2]), losses)
    for (name, a), b in zip(whole.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(whole.optimizer.mu + whole.optimizer.nu, resumed.optimizer.mu + resumed.optimizer.nu):
        assert torch.equal(a, b)
    assert whole.optimizer.count == resumed.optimizer.count == 4
    assert all(torch.equal(whole.carry[k], resumed.carry[k]) for k in whole.carry)
    # the Adam moments are stored by parameter name
    payload = torch.load(path, weights_only=True)
    assert "denoise_1.conv1.weight" in payload["mu"] and payload["count"] == 2

    for e in (1, 10, 2):
        (tmp_path / f"state_{e}.pt").write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "state_10.pt")
    assert latest_checkpoint(str(tmp_path / "nowhere")) is None


def test_config_matches_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.Config)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.Config)}
    assert tf == jf
    argv = ["--lr", "0.001", "--epochs", "2", "--model_pretrain", "w.pt", "--resume", "auto", "--precision", "fast",
            "--chunk", "4", "--enh_scale", "2", "--prefetch_depth", "3", "--compute_dtype", "bfloat16",
            "--frame_width", "64", "--frame_height", "48", "--dataset", "DID", "--raft_weights", "r.pth"]
    parsed = []
    for mod in (jconfig, tconfig):
        parser = argparse.ArgumentParser()
        mod.add_config_args(parser)
        parsed.append(dataclasses.asdict(mod.config_from_args(parser.parse_args(argv))))
    assert parsed[0] == parsed[1] and parsed[1]["lr"] == 0.001 and parsed[1]["model_pretrain"] == "w.pt"
    assert json.dumps(parsed[1])  # plain values only


@pytest.mark.parametrize("flag,value,item", [("mesh_data", 2, "item 9"), ("mesh_spatial", 4, "item 9"),
                                             ("spatial_bands", 4, "item 8")])
def test_unsupported_values_raise(flag, value, item):
    """Values the port once refused: banded training (ROADMAP queue 1 item 8)
    and multi-device runs (item 9) are ported now, so each value is taken as
    it is; a frame the mesh's spatial axis cannot band still raises."""
    parser = argparse.ArgumentParser()
    tconfig.add_config_args(parser)
    assert getattr(tconfig.Config(**{flag: value}), flag) == value
    assert getattr(tconfig.config_from_args(parser.parse_args([f"--{flag}", str(value)])), flag) == value
    if flag == "mesh_spatial":
        # 100 rows make 4 bands of 25: odd, and the pair maps need even rows
        with pytest.raises(ValueError, match="even band heights"):
            tconfig.Config(mesh_spatial=value, frame_height=100)
        with pytest.raises(ValueError, match="even band heights"):
            tconfig.config_from_args(parser.parse_args([f"--{flag}", str(value), "--frame_height", "100"]))
