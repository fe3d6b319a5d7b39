"""Tests of the benchmark. They run on the CPU with no card, from the
checkout's root:

    python -m pytest h100_bench/tests -q

Tests marked `cuda` need the card; each decides that inside the test and
skips here. On the card they hold the comparison's control and its limits
at the cells' own sizes.
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a cell's configuration cut to a size the CPU runs in seconds, computed in
# float32 so that a sound run reads far inside the cells' limits
TINY = dict(feature_layer="layer2", N0=512, N1=16, N2=8, N3=4, dict_size=5, num_classes=3,
            image_size=32, compute_dtype="float32", optimizer_dtype="float32")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is unavailable")


@pytest.fixture
def spec():
    from h100_bench import core

    return core.load_json(core.ROOT / "BENCHMARK.json")


@pytest.fixture
def tiny_spec(spec, tmp_path):
    """BENCHMARK.json with each configuration's file replaced by its TINY cut."""
    from h100_bench import core

    out = copy.deepcopy(spec)
    for c in out["configs"]:
        cfg = core.load_json(core.ROOT / c["file"]) | TINY
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    return out


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
