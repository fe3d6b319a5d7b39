"""Data layer: dataset indices, host loaders, packed crop caches, on-device
target transforms.

The JAX package's exports, except the tangent-residual targets of the
presets that are not ported yet (ROADMAP.md)."""

from multi_modal_regression_tpu_torch.data.naming import (
    PASCAL3D_CLASSES,
    ParsedName,
    make_name,
    parse_name,
)
from multi_modal_regression_tpu_torch.data.index import (
    ClassBalancedIndex,
    FlatTestIndex,
    MatCropIndex,
)
from multi_modal_regression_tpu_torch.data.loader import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    BalancedLoader,
    FlatLoader,
    MatCropLoader,
    TestLoader,
    decode_image,
    normalize_images,
)
from multi_modal_regression_tpu_torch.data.packed import (
    PackedBalancedLoader,
    PackedCrops,
    PackedFlatLoader,
    PackedMatCropLoader,
    PackedMatCrops,
    PackedTestLoader,
    pack_index,
    pack_mat_index,
)
from multi_modal_regression_tpu_torch.data.targets import (
    euler_to_pose,
    gmm_log_responsibilities,
    gmm_soft_targets,
    hard_bin_targets,
    pairwise_sqeuclidean,
    rbf_soft_targets,
)

__all__ = [
    "PASCAL3D_CLASSES",
    "ParsedName",
    "make_name",
    "parse_name",
    "ClassBalancedIndex",
    "FlatTestIndex",
    "MatCropIndex",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "BalancedLoader",
    "FlatLoader",
    "MatCropLoader",
    "TestLoader",
    "decode_image",
    "normalize_images",
    "PackedBalancedLoader",
    "PackedCrops",
    "PackedFlatLoader",
    "PackedMatCropLoader",
    "PackedMatCrops",
    "PackedTestLoader",
    "pack_index",
    "pack_mat_index",
    "euler_to_pose",
    "gmm_log_responsibilities",
    "gmm_soft_targets",
    "hard_bin_targets",
    "pairwise_sqeuclidean",
    "rbf_soft_targets",
]
