"""Zero-TIG's parameters under the published key names, with their shapes.

The names are those of the reference PyTorch model (L-Forster/Zero-TIG
``model/model.py``, RAFT ``model/RAFT/``), so one state dict loads into the
program and into this reference alike. Widths: the Enhancer 9->64 with one
shared 64->64 conv+BatchNorm block used three times and 64->3 out; both
denoisers 48 channels wide (Denoise_1 3->3, Denoise_2 12->6); RAFT with 128
hidden and 128 context channels, a 256-channel feature net, 4 correlation
levels of radius 4 (Teed & Deng, arXiv:2003.12039).

``PARAMS`` lists each tensor once: (key, shape, kind), kind one of
"conv_w", "conv_b", "bn_w", "bn_b", "bn_mean", "bn_var". ``ALIASES`` maps a
second name of a shared module's tensor to its first: the reference model
registers the Enhancer's block under ``conv`` and ``blocks.{0,1,2}``, and a
strided RAFT block's BatchNorm under ``norm3`` and ``downsample.1``.
"""

from __future__ import annotations

ENH_CH, ENH_LAYERS, DEN_CH = 64, 3, 48
HIDDEN, CONTEXT, FNET_DIM = 128, 128, 256
CORR_LEVELS, CORR_RADIUS = 4, 4
CORR_CH = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2  # 324

WIDTHS = {
    "enhancer_channels": ENH_CH, "enhancer_layers": ENH_LAYERS, "denoise_channels": DEN_CH,
    "raft_hidden": HIDDEN, "raft_context": CONTEXT, "raft_fnet_dim": FNET_DIM,
    "corr_levels": CORR_LEVELS, "corr_radius": CORR_RADIUS,
}


def check_widths(config: dict) -> None:
    """A configuration's widths must be this model's: neither side can run others."""
    wrong = {k: config.get(k) for k, v in WIDTHS.items() if config.get(k) != v}
    if wrong:
        raise ValueError(f"{config.get('name')}: widths {wrong} differ from the model's {WIDTHS}")


def _conv(key: str, cout: int, cin: int, kh: int, kw: int | None = None) -> list:
    return [(f"{key}.weight", (cout, cin, kh, kw or kh), "conv_w"), (f"{key}.bias", (cout,), "conv_b")]


def _bn(key: str, c: int) -> list:
    return [(f"{key}.weight", (c,), "bn_w"), (f"{key}.bias", (c,), "bn_b"),
            (f"{key}.running_mean", (c,), "bn_mean"), (f"{key}.running_var", (c,), "bn_var")]


def _encoder(pre: str, out_dim: int, batch_norm: bool) -> list:
    specs = _conv(f"{pre}.conv1", 64, 3, 7) + (_bn(f"{pre}.norm1", 64) if batch_norm else [])
    cin = 64
    for i, dim in enumerate((64, 96, 128), start=1):
        for j in range(2):
            blk = f"{pre}.layer{i}.{j}"
            c_in = cin if j == 0 else dim
            specs += _conv(f"{blk}.conv1", dim, c_in, 3) + _conv(f"{blk}.conv2", dim, dim, 3)
            if batch_norm:
                specs += _bn(f"{blk}.norm1", dim) + _bn(f"{blk}.norm2", dim)
            if j == 0 and i > 1:
                if batch_norm:
                    specs += _bn(f"{blk}.norm3", dim)
                specs += _conv(f"{blk}.downsample.0", dim, c_in, 1)
        cin = dim
    return specs + _conv(f"{pre}.conv2", out_dim, 128, 1)


def _update_block() -> list:
    pre = "raft.update_block"
    specs = (_conv(f"{pre}.encoder.convc1", 256, CORR_CH, 1) + _conv(f"{pre}.encoder.convc2", 192, 256, 3)
             + _conv(f"{pre}.encoder.convf1", 128, 2, 7) + _conv(f"{pre}.encoder.convf2", 64, 128, 3)
             + _conv(f"{pre}.encoder.conv", 128 - 2, 64 + 192, 3))
    for n, (kh, kw) in (("1", (1, 5)), ("2", (5, 1))):
        for gate in "zrq":
            specs += _conv(f"{pre}.gru.conv{gate}{n}", HIDDEN, HIDDEN + 128 + HIDDEN, kh, kw)
    specs += _conv(f"{pre}.flow_head.conv1", 256, HIDDEN, 3) + _conv(f"{pre}.flow_head.conv2", 2, 256, 3)
    return specs + _conv(f"{pre}.mask.0", 256, HIDDEN, 3) + _conv(f"{pre}.mask.2", 64 * 9, 256, 1)


PARAMS = (
    _conv("enhance.in_conv.0", ENH_CH, 9, 3) + _conv("enhance.conv.0", ENH_CH, ENH_CH, 3)
    + _bn("enhance.conv.1", ENH_CH) + _conv("enhance.out_conv.0", 3, ENH_CH, 3)
    + _conv("denoise_1.conv1", DEN_CH, 3, 3) + _conv("denoise_1.conv2", DEN_CH, DEN_CH, 3)
    + _conv("denoise_1.conv3", 3, DEN_CH, 1)
    + _conv("denoise_2.conv1", DEN_CH, 12, 3) + _conv("denoise_2.conv2", DEN_CH, DEN_CH, 3)
    + _conv("denoise_2.conv3", 6, DEN_CH, 1)
    + _encoder("raft.fnet", FNET_DIM, False) + _encoder("raft.cnet", HIDDEN + CONTEXT, True) + _update_block()
)

# the tensors training moves: the Enhancer and both denoisers (RAFT is frozen)
TRAINABLE = tuple(k for k, _, kind in PARAMS
                  if k.startswith(("enhance.", "denoise_")) and kind in ("conv_w", "conv_b", "bn_w", "bn_b"))


def _aliases() -> dict[str, str]:
    out = {}
    for k, _, _ in PARAMS:
        if k.startswith("enhance.conv."):
            for i in range(ENH_LAYERS):
                out[k.replace("enhance.conv.", f"enhance.blocks.{i}.")] = k
        if k.startswith("raft.cnet.") and ".norm3." in k:
            out[k.replace(".norm3.", ".downsample.1.")] = k
    return out


ALIASES = _aliases()


def full_state(canonical: dict) -> dict:
    """``canonical`` (one entry per ``PARAMS`` key) with every alias added,
    each the same tensor as the name it stands for."""
    return {**canonical, **{alias: canonical[k] for alias, k in ALIASES.items()}}
