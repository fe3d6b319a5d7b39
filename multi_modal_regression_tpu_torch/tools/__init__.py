"""Tools around the training path: the pose-dictionary fit over an image
tree (tools/parity.py) and the timing of the fused conv+BN kernels at the
trunk's shapes on the card (tools/time_fused.py). The data-preparation
writers of the JAX package's tools/ are not ported yet (ROADMAP.md)."""
