"""ZebraPose inference on PyTorch and CUDA (NVIDIA Hopper).

A port of the `zebrapose_tpu` JAX package, module for module: the same
sub-packages (`codec`, `data`, `models`, `ops`, `eval`, `utils`) and the
same public layout (NHWC images, code/bit axis last, BGR channels). The
JAX package's one Pallas kernel, the minimal-set EPnP hypothesis stage,
is a hand-written CUDA kernel here (`csrc/epnp_minimal.cu`, built with
nvcc at first use and bound with ctypes).

Modules: `codec` (surface code, LUT), `data` (PNG reader/writer, BOP
walk, detections, BOP CSV, the host dataset and device preprocessing),
`models` (ZebraPoseNet v1/v2), `ops` (crop, binarize, EPnP-RANSAC and
its kernel, ADD/ADD-S), `eval` (the batch program, `run_inference`,
`run_test`), `utils`, `config` and `cli` (`python -m
zebrapose_tpu_torch test`).

Entry points run on CUDA unless the caller passes `device="cpu"` (or CPU
tensors); with no device given and no CUDA present they raise. This
package imports neither JAX, cv2 nor PIL, nor anything of
`zebrapose_tpu`.
"""
