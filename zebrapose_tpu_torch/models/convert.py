"""JAX ZebraPoseNet variables -> the port's state dict; ImageNet
backbone weights -> the port's model.

The port's copy of the mapping in `zebrapose_tpu/models/convert_torch.py`
(`_walk_reference`, the export mapping and `_CONCAT_ALIASES`), without
flax. The port's module names are the reference checkpoints' keys, so
the result is also a reference-format state dict.
`load_torchvision_resnet34` is the counterpart of
`convert_torchvision_resnet34` + `merge_pretrained` (:306-344).

Conventions (inverse of the JAX importer):
  * conv kernel  [kh, kw, in, out] -> weight [out, in, kh, kw]
  * convT kernel [kh, kw, out, in] -> weight [in, out, kh, kw]
    (both .transpose(3, 2, 0, 1))
  * BN scale/bias/mean/var -> weight/bias/running_mean/running_var,
    num_batches_tracked = 0
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

_BLOCK_STAGES = (("layer1", "resnet.4", 3), ("layer2", "resnet.5", 4),
                 ("layer4", "layer4", 6), ("layer5", "layer5", 3))
_ASPP_CONVS = ("conv_1x1_1", "conv_3x3_1", "conv_3x3_2", "conv_3x3_3",
               "conv_1x1_2", "conv_1x1_3")
# The reference registers stem/layer1/layer2 twice (skip-tap
# Sequentials); a strict load wants both key families.
_CONCAT_ALIASES = (
    ("net.resnet.resnet.0.", "net.resnet.resnet_layer_1.0."),  # conv1
    ("net.resnet.resnet.1.", "net.resnet.resnet_layer_1.1."),  # bn1
    ("net.resnet.resnet.4.", "net.resnet.resnet_layer_2.1."),  # layer1
    ("net.resnet.resnet.5.", "net.resnet.resnet_layer_3.0."),  # layer2
)


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], np.ndarray]:
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


class _StateDictWriter:
    def __init__(self, variables: Dict[str, Any]):
        self.params = _flatten(variables.get("params", {}))
        self.stats = _flatten(variables.get("batch_stats", {}))
        self.sd: Dict[str, np.ndarray] = {}

    def conv(self, ours: Tuple[str, ...], theirs: str, bias: bool = False):
        self.sd[theirs + ".weight"] = \
            self.params[ours + ("kernel",)].transpose(3, 2, 0, 1)
        if bias:
            self.sd[theirs + ".bias"] = self.params[ours + ("bias",)]

    convt = conv

    def bn(self, ours: Tuple[str, ...], theirs: str):
        self.sd[theirs + ".weight"] = self.params[ours + ("scale",)]
        self.sd[theirs + ".bias"] = self.params[ours + ("bias",)]
        self.sd[theirs + ".running_mean"] = self.stats[ours + ("mean",)]
        self.sd[theirs + ".running_var"] = self.stats[ours + ("var",)]
        self.sd[theirs + ".num_batches_tracked"] = np.asarray(0, np.int64)

    def basic_block(self, ours: Tuple[str, ...], theirs: str):
        self.conv(ours + ("conv1", "conv"), theirs + ".conv1")
        self.bn(ours + ("bn1", "bn"), theirs + ".bn1")
        self.conv(ours + ("conv2", "conv"), theirs + ".conv2")
        self.bn(ours + ("bn2", "bn"), theirs + ".bn2")
        if ours + ("downsample_conv", "conv", "kernel") in self.params:
            self.conv(ours + ("downsample_conv", "conv"),
                      theirs + ".downsample.0")
            self.bn(ours + ("downsample_bn", "bn"), theirs + ".downsample.1")

    def upsample(self, ours: Tuple[str, ...], theirs: str):
        self.convt(ours + ("deconv",), theirs + ".0")
        self.bn(ours + ("bn0", "bn"), theirs + ".1")
        self.conv(ours + ("conv1", "conv"), theirs + ".3")
        self.bn(ours + ("bn1", "bn"), theirs + ".4")
        self.conv(ours + ("conv2", "conv"), theirs + ".6")
        self.bn(ours + ("bn2", "bn"), theirs + ".7")


def _walk_reference(eb: _StateDictWriter) -> None:
    """The flax <-> reference leaf mapping for v1/v2 on ResNet34."""
    root = "net.resnet"
    eb.conv(("resnet", "conv1", "conv"), f"{root}.resnet.0")
    eb.bn(("resnet", "bn1", "bn"), f"{root}.resnet.1")
    for ours, theirs, n in _BLOCK_STAGES:
        for i in range(n):
            eb.basic_block(("resnet", f"{ours}_{i}"), f"{root}.{theirs}.{i}")
    for name in _ASPP_CONVS:
        eb.conv(("aspp", name, "conv", "conv"), f"net.aspp.{name}",
                bias=True)
        eb.bn(("aspp", name, "bn", "bn"), f"net.aspp.bn_{name}")
    eb.upsample(("aspp", "upsample_1"), "net.aspp.upsample_1")
    eb.upsample(("aspp", "upsample_2"), "net.aspp.upsample_2")
    eb.conv(("aspp", "conv_1x1_4", "conv"), "net.aspp.conv_1x1_4", bias=True)


def variables_to_state_dict(variables: Dict[str, Any], variant: str = "v2"
                            ) -> Dict[str, torch.Tensor]:
    """JAX {"params", "batch_stats"} tree (numpy leaves) -> a state dict
    that `ZebraPoseNet(variant=variant).load_state_dict(sd)` accepts
    strictly. v1 and v2 share the key set (only the head width
    differs)."""
    if variant not in ("v1", "v2"):
        raise NotImplementedError(f"variant {variant!r} is not ported yet "
                                  "(see ROADMAP.md, queue A)")
    eb = _StateDictWriter(variables)
    _walk_reference(eb)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in _fill_aliases(eb.sd).items()}


def _fill_aliases(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Give every canonical stem / layer1 / layer2 key its skip-tap alias
    (`_CONCAT_ALIASES`) where the alias is absent; in place."""
    for src, dst in _CONCAT_ALIASES:
        for k in [k for k in sd if k.startswith(src)]:
            sd.setdefault(dst + k[len(src):], sd[k])
    return sd


def reference_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A reference checkpoint's `model_state_dict` as the port's model
    loads it strictly: DDP `module.` prefixes stripped (train_v5/v6
    checkpoints; `convert_torch.py::strip_ddp_prefix` in the JAX
    package) and absent skip-tap aliases filled from the canonical
    `net.resnet.resnet.*` family (a checkpoint saved with
    concat_decoder = False has no `resnet_layer_*` keys). Any other
    missing key is left for the strict load to reject."""
    return _fill_aliases({k[len("module."):] if k.startswith("module.")
                          else k: v for k, v in sd.items()})


# torchvision resnet34 key prefix -> the port's module (the stem and the
# first two stages, which the reference loads pretrained,
# model/resnet.py:184-199)
_TORCHVISION_PREFIXES = (("conv1.", "net.resnet.resnet.0."),
                         ("bn1.", "net.resnet.resnet.1."),
                         ("layer1.", "net.resnet.resnet.4."),
                         ("layer2.", "net.resnet.resnet.5."))


def load_torchvision_resnet34(model: torch.nn.Module,
                              sd: Dict[str, Any]) -> None:
    """Copy a torchvision resnet34 state dict's stem, layer1 and layer2
    (conv weights, BN weight / bias / running statistics) into
    ZebraPoseNet `model` in place, with shape checks; the rest of the
    model keeps its initialization. The skip-tap aliases
    (`_CONCAT_ALIASES`) share these modules, so they follow."""
    own = model.state_dict()
    with torch.no_grad():
        for src, dst in _TORCHVISION_PREFIXES:
            for key in [k for k in own if k.startswith(dst)
                        and not k.endswith("num_batches_tracked")]:
                theirs = src + key[len(dst):]
                if theirs not in sd:
                    raise KeyError(f"pretrained state dict lacks {theirs}")
                value = torch.as_tensor(np.asarray(sd[theirs]))
                if tuple(value.shape) != tuple(own[key].shape):
                    raise ValueError(
                        f"shape mismatch at {theirs}: {tuple(value.shape)} "
                        f"vs {tuple(own[key].shape)}")
                own[key].copy_(value)
