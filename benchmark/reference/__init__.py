"""The benchmark's plain reference: frozen copies of the port's v2
ResNet34 network, its int8 arithmetic, crop, decode (binarize, LUT
correspondences, RANSAC, minimal-set EPnP, scoring, refit, polish),
augmentation and losses, in plain PyTorch, plus Adam, the readers of
the committed `.npz` files and the training control's fp8 arithmetic.
It imports nothing of the port and nothing of JAX; the kernels' places
are taken by their plain arithmetic."""
