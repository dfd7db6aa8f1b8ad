"""ZebraPose training and inference on PyTorch and CUDA (NVIDIA Hopper).

A port of the `zebrapose_tpu` JAX package, module for module: the same
sub-packages (`codec`, `data`, `models`, `ops`, `eval`, `utils`) and the
same public layout (NHWC images, code/bit axis last, BGR channels). The
JAX package's one Pallas kernel, the minimal-set EPnP hypothesis stage,
is a hand-written CUDA kernel here (`csrc/epnp_minimal.cu`, built with
nvcc at first use and bound with ctypes); its host C++ depth rasterizer
is copied as `csrc/zebra_native.cpp` (built with c++, `native`).

Modules: `codec` (surface code, LUT), `data` (PNG reader/writer, BOP
walk, detections, BOP CSV, the host dataset, the training batch iterator
and device preprocessing), `models` (ZebraPoseNet v1/v2, the loss stack,
checkpoint conversion), `ops` (crop, GDR-Net augmentation, binarize,
EPnP-RANSAC and its kernel, ADD/ADD-S, the BOP19 errors), `eval` (the
batch program, `run_inference`, `run_test`, the multi-instance `vivo`
runner, BOP19 scoring), `native` (the rasterizer), `train` (state,
step, checkpoints, `fit`), `parallel` (world-size helpers), `utils`,
`config` and `cli` (`python -m zebrapose_tpu_torch train | test | vivo
| score-bop | merge-csv`).

Entry points run on CUDA unless the caller passes `device="cpu"` (or CPU
tensors); with no device given and no CUDA present they raise. This
package imports neither JAX, cv2 nor PIL, nor anything of
`zebrapose_tpu`.
"""
