"""Metric sink: one JSON record a line in `<workdir>/metrics.jsonl` (the
port's copy of the JAX package's utils/metrics_writer.py).

Replaces the reference's tensorboardX SummaryWriter usage
(learnGeodesicBDModel.py:99,136-137,187-194): the same scalar names
(train_loss, alpha, val_loss) are written. TensorBoard output is not
ported yet: `tensorboard=True` raises rather than being ignored.
"""

from __future__ import annotations

import json
from pathlib import Path


class MetricsWriter:
    def __init__(self, workdir: str | Path, tensorboard: bool = False):
        if tensorboard:
            raise NotImplementedError(
                "TensorBoard output is not ported yet; metrics.jsonl holds "
                "every record (ROADMAP.md)"
            )
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.path = self.workdir / "metrics.jsonl"

    def write(self, step: int, scalars: dict) -> None:
        """Append {"step": step, **scalars} as one line. The file is opened
        for each record, so a record is on disk when write returns and no
        handle outlives the call."""
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
