"""parallel: see the package docstring; modules mirror zebrapose_tpu/parallel/."""
