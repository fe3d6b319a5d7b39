"""Tools around the training path: synthetic datasets and releases
(tools/synthetic.py), the data preparation of a PASCAL3D+ / ObjectNet3D
release (tools/pascal3d_prep.py, tools/ingest.py), the pose-dictionary fit
and the quality-parity gate (tools/parity.py), and the timing of the fused
conv+BN kernels at the trunk's shapes on the card (tools/time_fused.py)."""
