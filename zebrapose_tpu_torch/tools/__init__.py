"""tools: offline GT generation (surface code, label images); modules
mirror zebrapose_tpu/tools/."""
