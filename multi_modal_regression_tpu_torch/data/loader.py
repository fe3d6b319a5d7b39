"""Image normalization constants and the plain normalize.

The host loaders are not ported yet; this module holds what the serving
path needs: the ImageNet constants and the plain PyTorch form of the
on-device (x/255 - mean)/std (the JAX package's data/loader.py).
"""

from __future__ import annotations

import numpy as np
import torch

# ImageNet normalization (dataGenerators.py:21)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_images(
    x_uint8: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(x/255 - mean)/std on (..., H, W, 3) uint8, on the tensor's device.

    The arithmetic runs in at least float32 (float64 stays float64); only
    the output takes `dtype`. This is the plain version of the normalize
    kernel (ops/preprocess.py) and its reference.
    """
    compute = torch.promote_types(torch.float32, dtype)
    x = x_uint8.to(compute) / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device).to(compute)
    std = torch.as_tensor(IMAGENET_STD, device=x.device).to(compute)
    return ((x - mean) / std).to(dtype)
