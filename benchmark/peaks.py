"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity), at its full 700 W power limit."""

FLOPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops_by_precision) -> float:
    """The least time the chip needs for operations at their precisions'
    peaks."""
    return sum(v / FLOPS_PER_S[k] for k, v in flops_by_precision.items())
