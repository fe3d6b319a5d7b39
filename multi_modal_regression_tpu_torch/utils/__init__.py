"""Metric sinks (utils/metrics_writer.py)."""
