"""Host-side evaluation metrics (numpy, float64). The detection metrics
(the JAX package's metrics/detection.py) come with the detection protocol
(ROADMAP.md)."""

from multi_modal_regression_tpu_torch.metrics.pose_error import (
    geodesic_error_deg,
    mean_class_accuracy,
    mean_class_median_error,
    per_class_report,
    pose_error_stats,
    quaternion_error_deg,
)

__all__ = [
    "geodesic_error_deg",
    "quaternion_error_deg",
    "pose_error_stats",
    "mean_class_median_error",
    "mean_class_accuracy",
    "per_class_report",
]
