"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit), one per precision.

float32 is the split-TF32 rate (495 TFLOP/s over the three TF32 products
that make one float32 product), the rate at which the port's kernels
compute float32 products. cuBLAS float32 products with TF32 off run on the
67 TFLOP/s units, but a share against that rate would pass 100 % as soon
as such a product moved onto split TF32: the one float32 peak is the
higher one.
"""

PEAK_OPS = {
    "bf16": 989e12,
    "float32": 495e12 / 3,
}
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float, ops: float, precision: str) -> float:
    """The least time the card could take: the larger of the bytes over the
    bandwidth and the operations over the precision's peak."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS[precision])
