"""multi_modal_regression_tpu_torch — the PyTorch + CUDA port for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths so each
counterpart is found by name. It imports `torch`, `numpy`, the standard
library, and on the host side PIL and scipy (image files, `.mat` files):
never JAX, flax, optax, orbax or the JAX package, so it runs on a machine
that has none of them.

What is ported so far: the serving and training paths of all 42 of the
JAX package's presets (the single-model pose zoo, the two-stage and joint
category + pose pipelines, the ObjectNet3D label-concat models), every
ExperimentConfig field but `tensorboard`, the pose-dictionary path that
comes before every bin-delta training run, and the chain from a raw
release through the detection metrics to the quality-parity gate:

data        ImageNet constants, plain `normalize_images`, `euler_to_pose`,
            hard, GMM-posterior, RBF soft and SO(3) tangent targets;
            file-name pose parsing (`naming`) and the class-balanced index
            (`index`)
ops         hand-written CUDA kernels (normalize; stem BN+ReLU+max-pool,
            forward and backward; fused conv+BN; pose-bin assignment), each
            beside its plain PyTorch version; `_build` compiles them;
            `augment`, the on-device resize and flips
geometry    SO(3) exp/log maps and Euler angles; quaternions
dictionary  `fit_kmeans` (greedy kmeans++, Lloyd), `fit_gmm` (EM),
            `KMeansDictionary`, `GMMDictionary` over the JAX package's
            `.npz` files, `get_gamma`, `pairwise_sqeuclidean`
models      ResNet and VGG trunks, per-class head banks and `SharedMLP` in
            eval and train mode, the bin-delta and multires models, the
            regression, classification, class-agnostic and label-concat
            models (`pose`), the joint models, `from_jax_variables`,
            torchvision and reference-checkpoint loading (`pretrained`),
            the trunks' checkpointed segments (`checkpoint`)
losses      the primitive and composed bin-delta losses, self-balance
train       42 presets (`PRESETS`), their problems, Adam, the epoch
            learning-rate factors, the train and eval steps, `remat`,
            `TrainState`, `Trainer.fit`, the snapshot-ensemble evaluator
metrics     pose errors, MedErr, Acc@30; AP / AVP / ARP (`detection`)
detection   detector crop sets, `run_detection_inference`, results .mat
            files, `evaluate_detection_results`
tools       `synthetic` datasets and releases, `pascal3d_prep` (crops,
            homography augmentation), `ingest` (release walkers, detector
            parsers), `parity` (`fit_pose_dictionary`, `run_parity_gate`)
cli         `python -m multi_modal_regression_tpu_torch.cli` train, pack,
            evaluate, predict, dictionary, prepare-data,
            prepare-detections, evaluate-detections, verify-parity
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
