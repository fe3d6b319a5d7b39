"""Host-side evaluation metrics (numpy, float64): pose errors and the
detection protocol's AP / AVP / ARP (the JAX package's exports)."""

from multi_modal_regression_tpu_torch.metrics.pose_error import (
    geodesic_error_deg,
    mean_class_accuracy,
    mean_class_median_error,
    per_class_report,
    pose_error_stats,
    quaternion_error_deg,
)
from multi_modal_regression_tpu_torch.metrics.detection import (
    box_overlap,
    compute_detection_metrics,
    voc_ap,
)

__all__ = [
    "geodesic_error_deg",
    "quaternion_error_deg",
    "pose_error_stats",
    "mean_class_median_error",
    "mean_class_accuracy",
    "per_class_report",
    "voc_ap",
    "box_overlap",
    "compute_detection_metrics",
]
