"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full power limit of 700 W). A roofline share is
stated against these, with the card's power limit beside it."""

F32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops: float, bytes_moved: float, flops_peak: float) -> tuple:
    """(least seconds, which bound sets it: "compute" or "memory")."""
    compute, memory = flops / flops_peak, bytes_moved / HBM_BYTES_PER_S
    return (compute, "compute") if compute >= memory else (memory, "memory")
