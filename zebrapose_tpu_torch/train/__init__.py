"""train: see the package docstring; modules mirror zebrapose_tpu/train/."""
