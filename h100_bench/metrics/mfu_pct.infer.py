"""The model's FLOPs (configs/<family>.py) of the traced units over the
traced sub-window's time, as a share of the H100's 989 TFLOP/s dense bf16."""

from h100_bench.metrics._shared import mfu_pct as read  # noqa: F401
