"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

  preprocess     normalize_images_cuda   uint8 NHWC -> normalized f32/bf16
  stem_pool      stem_bn_relu_pool       BN affine + ReLU + max-pool 3x3/2, an
                                         autograd Function whose backward is
                 stem_pool_bwd           the backward kernel
  fused_conv_bn  linear_bn_stats,        1x1 conv with BN prologue and
                 linear_stats,           statistics epilogue (forward kernel
                 conv1x1_bn_stats        `_mm_stats`, backward `_mm_stats_bwd`)
                 conv3x3_bn_stats        3x3 stride-1 conv likewise (`_c3_fwd`,
                                         `_c3_bwd`); autograd Functions
  adam           adam_update             Adam's step over a list of float32
                                         tensors in one pass (`adam_kernel`),
                                         beside its foreach passes
                                         `adam_update_plain`

A wrapper takes its plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel (built by `_build` on first use) or raises.
Each module counts its kernels' launches in module-level counters:
`preprocess.launches`, `stem_pool.launches`, `stem_pool.bwd_launches`,
`fused_conv_bn.mm_launches`, `mm_bwd_launches`, `c3_launches`,
`c3_bwd_launches`, `assign.launches`, `adam.launches`. A launch captured in a
CUDA graph is counted at each replay, not at the capture
(train/steps.GraphedTrainStep, adam.CapturedUpdate).
"""
