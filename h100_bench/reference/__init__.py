"""Plain PyTorch reference of the bin-delta pose models: float32 (TF32 off
around its own computation), no kernels, no batching tricks.

It is written for this benchmark from the published equations
(JHUVisionLab/multi-modal-regression, binDeltaModels.py, binDeltaLosses.py,
learnGeodesicBDModel.py; torchvision's ResNet v1.5) and imports nothing of
the port, of JAX or of the JAX package. It takes only the benchmark's inputs
(weights, atoms, images, poses, labels) and works out everything else again.
"""
