"""Metric sinks (utils/metrics_writer.py: metrics.jsonl, TensorBoard event
files) and profiling (utils/profiling.py: profile_trace, span)."""
