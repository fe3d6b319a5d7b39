"""multi_modal_regression_tpu_torch — the PyTorch + CUDA port for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths so each
counterpart is found by name. It imports `torch`, `numpy` and the standard
library only: never JAX, flax, optax, orbax, PIL or the JAX package, so it
runs on a machine that has none of them.

What is ported so far is the `geodesic_bd` serving and training paths:

data        ImageNet constants, plain `normalize_images`, `euler_to_pose`,
            `hard_bin_targets`
ops         hand-written CUDA kernels (normalize; stem BN+ReLU+max-pool,
            forward and backward), each beside its plain PyTorch version;
            `_build` compiles them
geometry    SO(3) exp/log maps and Euler angles
dictionary  `KMeansDictionary` read from the JAX package's `.npz` files,
            `pairwise_sqeuclidean`
models      ResNet trunk and per-class head banks in eval and train mode,
            `OneBinDeltaModel`, `from_jax_variables` weight conversion
losses      `decode_bin_delta`, the primitive losses, self-balance
train       the `geodesic_bd` preset, its problem, Adam, the train and eval
            steps, `TrainState`, `Trainer.fit`
serving     `make_inference_fn`: uint8 images + labels -> poses

The roadmap of what is still to port is in ROADMAP.md.
"""

__version__ = "0.1.0"

# Numeric precision constant shared across the framework
# (the JAX package's __init__.py).
EPS = 1e-6

# The 12 PASCAL3D+ object categories of interest.
PASCAL3D_CLASSES = (
    "aeroplane", "bicycle", "boat", "bottle", "bus", "car",
    "chair", "diningtable", "motorbike", "sofa", "train", "tvmonitor",
)
