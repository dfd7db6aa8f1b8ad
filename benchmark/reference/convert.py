"""A compact checkpoint's {"params", "batch_stats"} tree -> the v2
ResNet34 network's state dict: the reference's own copy of the mapping
in the port's `models/convert.py` (`_walk_reference`, the writer side,
`_CONCAT_ALIASES`). The network's module names are the reference
checkpoints' keys, so the result is also a reference-format state dict.

Conventions:
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

# (ours, reference prefix, blocks) of ResNet34's BasicBlock stages
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
    """Moves the tree's conv / BN leaf groups to the reference keys."""

    def __init__(self, variables: Dict[str, Any]):
        self.params = _flatten(variables.get("params", {}))
        self.stats = _flatten(variables.get("batch_stats", {}))
        self.sd: Dict[str, np.ndarray] = {}

    def conv(self, ours: Tuple[str, ...], theirs: str, bias: bool = False):
        self.sd[theirs + ".weight"] = \
            self.params[ours + ("kernel",)].transpose(3, 2, 0, 1)
        if bias:
            self.sd[theirs + ".bias"] = self.params[ours + ("bias",)]

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
        self.conv(ours + ("deconv",), theirs + ".0")
        self.bn(ours + ("bn0", "bn"), theirs + ".1")
        self.conv(ours + ("conv1", "conv"), theirs + ".3")
        self.bn(ours + ("bn1", "bn"), theirs + ".4")
        self.conv(ours + ("conv2", "conv"), theirs + ".6")
        self.bn(ours + ("bn2", "bn"), theirs + ".7")


def variables_to_state_dict(variables: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """A v2 ResNet34 {"params", "batch_stats"} tree (numpy leaves) -> a
    state dict that the reference `ZebraPoseNet` loads strictly."""
    w = _StateDictWriter(variables)
    root = "net.resnet"
    w.conv(("resnet", "conv1", "conv"), f"{root}.resnet.0")
    w.bn(("resnet", "bn1", "bn"), f"{root}.resnet.1")
    for ours, theirs, n in _BLOCK_STAGES:
        for i in range(n):
            w.basic_block(("resnet", f"{ours}_{i}"), f"{root}.{theirs}.{i}")
    for name in _ASPP_CONVS:
        w.conv(("aspp", name, "conv", "conv"), f"net.aspp.{name}", bias=True)
        w.bn(("aspp", name, "bn", "bn"), f"net.aspp.bn_{name}")
    w.upsample(("aspp", "upsample_1"), "net.aspp.upsample_1")
    w.upsample(("aspp", "upsample_2"), "net.aspp.upsample_2")
    w.conv(("aspp", "conv_1x1_4", "conv"), "net.aspp.conv_1x1_4", bias=True)
    for src, dst in _CONCAT_ALIASES:
        for k in [k for k in w.sd if k.startswith(src)]:
            w.sd.setdefault(dst + k[len(src):], w.sd[k])
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in w.sd.items()}
