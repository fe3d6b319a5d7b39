"""Filename-encoded pose parsing (the port's copy of the JAX package's
data/naming.py; numpy-free, standard library only).

The reference encodes the pose of each crop in its file name:
`<cls>_<imageid>object<j>_a<az>_e<el>_t<ct>_d<dist>` (written by
setupDataFlipped_pascal3d.m:120-121, parsed by helperFunctions.py:24-32).

Names are parsed from the RIGHT (rsplit on the last 4 underscores) so image
ids that themselves contain underscores (VOC '2008_000251', ImageNet
'n02690373_16') parse correctly; the reference's left-to-right underscore
indexing assumes exactly five underscores.
"""

from __future__ import annotations

from typing import NamedTuple

from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES

__all__ = ["PASCAL3D_CLASSES", "ParsedName", "parse_name", "make_name"]


class ParsedName(NamedTuple):
    prefix: str  # synset/class + image/model id (everything before the pose)
    az: float
    el: float
    ct: float
    d: float


def parse_name(image_name: str) -> ParsedName:
    """Parse `<prefix>_a<az>_e<el>_t<ct>_d<dist>` (no extension)."""
    prefix, a, e, t, d = image_name.rsplit("_", 4)
    if not (a[:1] == "a" and e[:1] == "e" and t[:1] == "t" and d[:1] == "d"):
        raise ValueError(f"cannot parse pose from image name {image_name!r}")
    return ParsedName(prefix, float(a[1:]), float(e[1:]), float(t[1:]), float(d[1:]))


def make_name(prefix: str, az: float, el: float, ct: float, d: float) -> str:
    """Inverse of parse_name, using the reference's '%f' fixed-point format."""
    return f"{prefix}_a{az:f}_e{el:f}_t{ct:f}_d{d:f}"
