"""torch's running-variance correction (`bessel_factor` of the JAX package's
models/norm.py).

torch BatchNorm normalizes with the biased batch variance but feeds the
running variance the unbiased one, var * n/(n-1). nn.BatchNorm2d does that
itself; the BNs written out by hand (the explicit stem BN, the head banks)
use this factor.
"""

from __future__ import annotations


def bessel_factor(count: int) -> float:
    """n/(n-1) as a python float; 1.0 for n <= 1."""
    n = int(count)
    return n / (n - 1) if n > 1 else 1.0
