"""Share of the traced sub-window in which nothing ran on the card."""

from h100_bench.metrics._shared import idle_pct as read  # noqa: F401
