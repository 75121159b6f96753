"""The peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W limit), and the least time a kernel could take.

Frozen from `chip_smoke.py` as of commit c976156:
`H100_BYTES_PER_S` and `H100_F32_PER_S` (lines 194-195) and `bound`
(:285-290). The kernels of the port compute in float32 outside the
tensor cores, so that is their operations' peak.
"""

BYTES_PER_S = 3.35e12  # HBM3
F32_PER_S = 67e12  # float32, outside the tensor cores


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """The larger of the bytes' and the operations' least times, in ms."""
    return max(n_bytes / BYTES_PER_S, n_ops / F32_PER_S) * 1e3
