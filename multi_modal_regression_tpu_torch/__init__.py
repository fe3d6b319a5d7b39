"""multi_modal_regression_tpu_torch — the PyTorch + CUDA port for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths so each
counterpart is found by name. It imports `torch`, `numpy` and the standard
library only: never JAX, flax, optax, orbax, PIL or the JAX package, so it
runs on a machine that has none of them.

What is ported so far: the `geodesic_bd` serving and training paths, the
pose-dictionary path that comes before every bin-delta training run, and
the soft-bin presets that train on those dictionaries:

data        ImageNet constants, plain `normalize_images`, `euler_to_pose`,
            hard, GMM-posterior and RBF soft bin targets; file-name pose
            parsing (`naming`) and the class-balanced index (`index`)
ops         hand-written CUDA kernels (normalize; stem BN+ReLU+max-pool,
            forward and backward; fused conv+BN; pose-bin assignment), each
            beside its plain PyTorch version; `_build` compiles them
geometry    SO(3) exp/log maps and Euler angles
dictionary  `fit_kmeans` (greedy kmeans++, Lloyd), `fit_gmm` (EM),
            `KMeansDictionary`, `GMMDictionary` over the JAX package's
            `.npz` files, `get_gamma`, `pairwise_sqeuclidean`
models      ResNet trunk and per-class head banks in eval and train mode,
            `OneBinDeltaModel`, `from_jax_variables` weight conversion
losses      `decode_bin_delta`, `expected_regression`, the primitive
            losses, self-balance
train       the `geodesic_bd`, `probabilistic_bd`, `relaxed_bd` and
            `ablation_xbd` presets, their problems, Adam, the epoch
            learning-rate factors, the train and eval steps, `TrainState`,
            `Trainer.fit`
tools       `gather_tree_poses`, `fit_pose_dictionary`
cli         `python -m multi_modal_regression_tpu_torch.cli dictionary`
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
