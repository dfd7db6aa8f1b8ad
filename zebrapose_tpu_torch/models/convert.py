"""JAX ZebraPoseNet variables <-> the port's state dict; reference
`.pth` checkpoints; ImageNet backbone weights -> the port's model.

The port's copy of the mapping in `zebrapose_tpu/models/convert_torch.py`
(`_walk_reference`, both directions, `_CONCAT_ALIASES`,
`export_reference_state_dict`, `save_reference_checkpoint`), without
flax. The port's module names are the reference checkpoints' keys, so
the result is also a reference-format state dict.
Every family of the model: v1 / v2 / v3, ResNet34 / ResNet50, base 2
and the non-binary heads. `load_torchvision_resnet34` is the
counterpart of `convert_torchvision_resnet34` + `merge_pretrained`
(:306-344); like them it fails with a shape error on a ResNet50 model,
and there is no ResNet50 ImageNet loader in either package.

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

_BLOCK_STAGES = {  # resnet_layers -> (ours, reference prefix, n, bottleneck)
    34: (("layer1", "resnet.4", 3, False), ("layer2", "resnet.5", 4, False),
         ("layer4", "layer4", 6, False), ("layer5", "layer5", 3, False)),
    50: (("layer1", "resnet.4", 3, True), ("layer2", "resnet.5", 4, True),
         ("layer4", "layer4", 6, False), ("layer5", "layer5", 3, False)),
}
_ASPP_CONVS = ("conv_1x1_1", "conv_3x3_1", "conv_3x3_2", "conv_3x3_3",
               "conv_1x1_2", "conv_1x1_3")
_ASPP_V3_CONVS = ("conv_1x1_1", "conv_3x3_1", "conv_3x3_2", "conv_1x1_2",
                  "conv_1x1_3")
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


class _Walker:
    """The structure shared by both directions of the mapping: a subclass
    moves one conv / BN leaf group (`conv`, `convt`, `bn`) and says
    whether a block has a downsample branch."""

    def basic_block(self, ours: Tuple[str, ...], theirs: str,
                    bottleneck: bool = False):
        self.conv(ours + ("conv1", "conv"), theirs + ".conv1")
        self.bn(ours + ("bn1", "bn"), theirs + ".bn1")
        self.conv(ours + ("conv2", "conv"), theirs + ".conv2")
        self.bn(ours + ("bn2", "bn"), theirs + ".bn2")
        if bottleneck:
            self.conv(ours + ("conv3", "conv"), theirs + ".conv3")
            self.bn(ours + ("bn3", "bn"), theirs + ".bn3")
        if self.has_downsample(ours, theirs):
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

    def aspp_trunk(self, ours_root: str, theirs_root: str, convs):
        for name in convs:
            self.conv((ours_root, name, "conv", "conv"),
                      f"{theirs_root}.{name}", bias=True)
            self.bn((ours_root, name, "bn", "bn"),
                    f"{theirs_root}.bn_{name}")
        self.upsample((ours_root, "upsample_1"), f"{theirs_root}.upsample_1")
        self.upsample((ours_root, "upsample_2"), f"{theirs_root}.upsample_2")


class _StateDictWriter(_Walker):
    """JAX variables -> reference keys (`convert_torch.py::
    _ExportBuilder`)."""

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

    def has_downsample(self, ours: Tuple[str, ...], theirs: str) -> bool:
        return ours + ("downsample_conv", "conv", "kernel") in self.params


class _TreeReader(_Walker):
    """Reference keys -> JAX variables (`convert_torch.py::_TreeBuilder`:
    the leaves keep the checkpoint's dtype, `num_batches_tracked` is
    dropped)."""

    def __init__(self, sd: Dict[str, Any]):
        self.sd = sd
        self.params: Dict[Tuple[str, ...], np.ndarray] = {}
        self.stats: Dict[Tuple[str, ...], np.ndarray] = {}

    def _get(self, key: str) -> np.ndarray:
        v = self.sd[key]
        return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))

    def conv(self, ours: Tuple[str, ...], theirs: str, bias: bool = False):
        self.params[ours + ("kernel",)] = \
            self._get(theirs + ".weight").transpose(2, 3, 1, 0)
        if bias:
            self.params[ours + ("bias",)] = self._get(theirs + ".bias")

    convt = conv

    def bn(self, ours: Tuple[str, ...], theirs: str):
        self.params[ours + ("scale",)] = self._get(theirs + ".weight")
        self.params[ours + ("bias",)] = self._get(theirs + ".bias")
        self.stats[ours + ("mean",)] = self._get(theirs + ".running_mean")
        self.stats[ours + ("var",)] = self._get(theirs + ".running_var")

    def has_downsample(self, ours: Tuple[str, ...], theirs: str) -> bool:
        return theirs + ".downsample.0.weight" in self.sd


def _unflatten(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _walk_reference(eb: _Walker, variant: str, nonbinary: bool,
                    resnet_layers: int) -> None:
    """The flax <-> reference leaf mapping of one model family
    (`convert_torch.py::_walk_reference`)."""
    root = "net.resnet"
    eb.conv(("resnet", "conv1", "conv"), f"{root}.resnet.0")
    eb.bn(("resnet", "bn1", "bn"), f"{root}.resnet.1")
    for ours, theirs, n, bneck in _BLOCK_STAGES[resnet_layers]:
        for i in range(n):
            eb.basic_block(("resnet", f"{ours}_{i}"), f"{root}.{theirs}.{i}",
                           bottleneck=bneck)
    eb.aspp_trunk("aspp", "net.aspp", _ASPP_CONVS)
    if nonbinary:
        for head in ("conv_1x1_4_mask", "conv_1x1_4_code"):
            eb.conv(("aspp", head, "conv"), f"net.aspp.{head}", bias=True)
        return
    eb.conv(("aspp", "conv_1x1_4", "conv"), "net.aspp.conv_1x1_4", bias=True)
    if variant == "v3":
        eb.aspp_trunk("aspp_v3", "net.aspp_v3", _ASPP_V3_CONVS)
        eb.conv(("aspp_v3", "conv_1x1_4", "conv"), "net.aspp_v3.conv_1x1_4",
                bias=True)


def _check_family(variant: str, resnet_layers: int) -> None:
    if variant not in ("v1", "v2", "v3"):
        raise ValueError(f"variant {variant!r}: v1, v2 or v3")
    if resnet_layers not in _BLOCK_STAGES:
        raise NotImplementedError(f"resnet_layers={resnet_layers}")


def variables_to_state_dict(variables: Dict[str, Any], variant: str = "v2",
                            nonbinary: bool = False, resnet_layers: int = 34
                            ) -> Dict[str, torch.Tensor]:
    """JAX {"params", "batch_stats"} tree (numpy leaves) of the family
    (`variant`, `nonbinary` = base > 2, `resnet_layers`) -> a state dict
    that the same `ZebraPoseNet` accepts strictly (v1 and v2 share the
    key set; only the head width differs)."""
    _check_family(variant, resnet_layers)
    eb = _StateDictWriter(variables)
    _walk_reference(eb, variant, nonbinary, resnet_layers)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in _fill_aliases(eb.sd).items()}


def state_dict_to_variables(sd: Dict[str, Any], variant: str = "v2",
                            nonbinary: bool = False,
                            resnet_layers: int = 34) -> Dict[str, Any]:
    """A reference-format state dict (the port's model's, or a `.pth`'s
    `model_state_dict`; DDP prefixes stripped) -> the JAX {"params",
    "batch_stats"} tree of numpy leaves: the port's copy of
    `convert_torch.py::convert_reference_state_dict`."""
    _check_family(variant, resnet_layers)
    tr = _TreeReader(reference_state_dict(dict(sd)))
    _walk_reference(tr, variant, nonbinary, resnet_layers)
    return {"params": _unflatten(tr.params),
            "batch_stats": _unflatten(tr.stats)}


def reference_family(sd: Dict[str, Any]) -> Tuple[str, bool, int]:
    """(variant, nonbinary, resnet_layers) of a reference-format state
    dict, from its keys: v1 and v2 share one key set (read as "v2"), v3
    adds `net.aspp_v3`, the non-binary heads replace `conv_1x1_4`, and
    ResNet50's blocks have `conv3`."""
    keys = {k[len("module."):] if k.startswith("module.") else k
            for k in sd}
    variant = "v3" if any(k.startswith("net.aspp_v3.") for k in keys) \
        else "v2"
    nonbinary = "net.aspp.conv_1x1_4_mask.weight" in keys
    layers = 50 if "net.resnet.resnet.4.0.conv3.weight" in keys else 34
    return variant, nonbinary, layers


def export_reference_state_dict(variables: Dict[str, Any],
                                variant: str = "v2",
                                nonbinary: bool = False,
                                resnet_layers: int = 34,
                                concat: bool = True
                                ) -> Dict[str, np.ndarray]:
    """JAX variables -> a reference-format state dict of numpy leaves
    (`convert_torch.py::export_reference_state_dict`): the walk's keys,
    `num_batches_tracked` = 0 (int64, 0-d) for every BN, and with
    `concat` the skip-tap aliases (`_CONCAT_ALIASES`) that a reference
    module built with concat_decoder = True registers."""
    _check_family(variant, resnet_layers)
    eb = _StateDictWriter(variables)
    _walk_reference(eb, variant, nonbinary, resnet_layers)
    if concat:
        for src, dst in _CONCAT_ALIASES:
            for k in [k for k in eb.sd if k.startswith(src)]:
                eb.sd[dst + k[len(src):]] = eb.sd[k]
    return eb.sd


def save_reference_checkpoint(path: str, variables: Dict[str, Any],
                              iteration_step: int = 0,
                              best_score: float = 0.0,
                              variant: str = "v2",
                              nonbinary: bool = False,
                              resnet_layers: int = 34,
                              concat: bool = True) -> None:
    """Write a reference-format `.pth` (utils_v2.save_checkpoint's dict:
    `model_state_dict`, `iteration_step`, `best_score`; the optimizer
    and scheduler states are left out, as the JAX package leaves them:
    the reference needs them to resume training, not to evaluate). The
    same dict, tensor for tensor, as
    `convert_torch.py::save_reference_checkpoint`."""
    sd = export_reference_state_dict(variables, variant=variant,
                                     nonbinary=nonbinary,
                                     resnet_layers=resnet_layers,
                                     concat=concat)
    torch.save({
        "model_state_dict": {
            k: torch.from_numpy(np.ascontiguousarray(v)) if v.ndim
            else torch.tensor(v) for k, v in sd.items()},
        "iteration_step": int(iteration_step),
        "best_score": float(best_score),
    }, path)


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
