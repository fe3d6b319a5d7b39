"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit)."""

PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes a second


def bound_s(nbytes: float, ops: float, peak_ops: float = PEAK_F32_FLOPS) -> float:
    """The least time the card could take: each input read and each output
    written once over the memory rate, or the operations over their peak
    (chip_smoke.bound, frozen here)."""
    return max(nbytes / PEAK_BYTES, ops / peak_ops)
