"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

  preprocess   normalize_images_cuda   uint8 NHWC -> normalized f32/bf16
  stem_pool    stem_bn_relu_pool       BN affine + ReLU + max-pool 3x3/2, an
                                       autograd Function whose backward is
               stem_pool_bwd           the backward kernel

A wrapper takes its plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel (built by `_build` on first use) or raises.
Each module counts its kernels' launches in module-level counters
(`launches`; `stem_pool.bwd_launches` for the backward).
"""
