"""codec: see the package docstring; modules mirror zebrapose_tpu/codec/."""
