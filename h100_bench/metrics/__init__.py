"""One reader a metric: `metrics/<metric name>.py` defines `read(run)`, which
returns the metric's value from a `core.Run`, or None where it finds nothing
to read (the harness then leaves the metric out of the result)."""
