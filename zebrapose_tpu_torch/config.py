"""Config system: reference-compatible flat `key = value` text files.

The port's copy of `zebrapose_tpu/config.py` (kept apart so the port
imports nothing of the JAX package). Parses the reference's config files
(its `config_parser.py`) with the same type coercion quirks
(`.isnumeric()` ints, four forced-float keys, bool strings, `type` ->
`_type`), then overlays a typed dataclass with defaults so the rest of
the package never touches raw dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

# Keys the reference force-coerces to float (config_parser.py:21).
_FORCED_FLOAT_KEYS = (
    "learning_rate",
    "padding_ratio",
    "train_obj_visible_theshold",
    "second_dataset_ratio",
)


def parse_cfg(cfgfile: str) -> Dict[str, Any]:
    """Parse a flat `key = value` config file into a dict.

    Mirrors the reference parser's behavior exactly so its shipped config
    files (config_BOP / config_paper / config_ablation) load unchanged.
    """
    block: Dict[str, Any] = {}
    with open(cfgfile, "r") as fp:
        for raw in fp:
            line = raw.rstrip()
            if line == "" or line[0] == "#":
                continue
            key, value = line.split("=", 1)
            key = key.strip()
            if key == "type":
                key = "_type"
            value: Any = value.strip()
            if isinstance(value, str) and value.isnumeric():
                value = int(value)
            if key in _FORCED_FLOAT_KEYS:
                value = float(value)
            if value == "False":
                value = False
            elif value == "True":
                value = True
            block[key] = value
    return block


@dataclasses.dataclass
class ZebraConfig:
    """Typed view over a reference config dict.

    Field names match the reference config keys one-to-one (e.g.
    `config/config_BOP/lmo/exp_lmo_BOP.txt`) so `ZebraConfig.from_dict(
    parse_cfg(path))` is lossless for the main training/eval path.
    """

    # --- dataset ---
    bop_challange: bool = False
    bop_path: str = ""
    dataset_name: str = "lmo"
    training_data_folder: str = "train_real"
    training_data_folder_2: str = "none"
    val_folder: str = "test"
    test_folder: str = "test"
    second_dataset_ratio: float = 0.75
    num_workers: int = 8
    train_obj_visible_theshold: float = 0.2

    # --- network ---
    BoundingBox_CropSize_image: int = 256
    BoundingBox_CropSize_GT: int = 128
    BinaryCode_Loss_Type: str = "BCE"  # L1 | BCE | CE
    mask_binary_code_loss: bool = True
    predict_entire_mask: bool = False
    use_histgramm_weighted_binary_loss: bool = True
    output_kernel_size: int = 1
    resnet_layer: int = 34
    concat_encoder_decoder: bool = True
    efficient_net_key: str = ""

    # --- checkpoints / logging ---
    load_checkpoint: bool = False
    check_point_path: str = "checkpoints/"
    tensorboard_path: str = "tb/"

    # --- optimizer ---
    optimizer_type: str = "Adam"
    learning_rate: float = 2e-4
    batch_size: int = 32
    total_iteration: int = 380_000
    binary_loss_weight: float = 3.0

    # --- augmentation / roi ---
    Detection_reaults: str = "none"  # (sic — reference key spelling)
    padding_ratio: float = 1.5
    resize_method: str = "crop_square_resize"
    use_peper_salt: bool = False
    use_motion_blur: bool = False

    # --- surface coding ---
    divide_number_each_itration: int = 2
    number_of_itration: int = 16

    # --- eval / refinement ---
    refine: bool = False
    ignore_bit: int = 0

    # extra keys we don't model explicitly
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ZebraConfig":
        field_names = {f.name for f in dataclasses.fields(cls)} - {"extras"}
        known = {k: v for k, v in d.items() if k in field_names}
        extras = {k: v for k, v in d.items() if k not in field_names}
        cfg = cls(**known, extras=extras)
        cfg.validate()
        return cfg

    @classmethod
    def from_file(cls, path: str) -> "ZebraConfig":
        return cls.from_dict(parse_cfg(path))

    def validate(self) -> None:
        if self.BinaryCode_Loss_Type not in ("L1", "BCE", "CE"):
            raise ValueError(
                f"unknown BinaryCode_Loss_Type: {self.BinaryCode_Loss_Type}")
        if self.resize_method not in (
                "crop_resize", "crop_square_resize",
                "crop_resize_by_warp_affine"):
            raise ValueError(f"unknown resize_method: {self.resize_method}")
        if self.use_histgramm_weighted_binary_loss and \
                self.BinaryCode_Loss_Type != "BCE":
            raise ValueError(
                "histogram-weighted loss requires BinaryCode_Loss_Type=BCE")
        d, n = self.divide_number_each_itration, self.number_of_itration
        if d < 2 or n < 1:
            raise ValueError(f"bad surface-code shape d={d} n={n}")

    @property
    def total_classes(self) -> int:
        return self.divide_number_each_itration ** self.number_of_itration

    @property
    def binary_code_length(self) -> int:
        return self.number_of_itration

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        extras = d.pop("extras")
        d.update(extras)
        return d
