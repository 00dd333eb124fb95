"""The work a block needs, counted from (k, field) alone, and the least
time one H100 could do it in: the yardstick of the rooflines.

The counts follow the algorithm's formulation, not any implementation,
so a roofline reads the same work whatever computes the layer. A cheaper
formulation (an FFT pass in place of the bit-sliced product, say) would
make the extension's count stale; only a benchmark change may correct it.
Copied from the arithmetic of the port's ``chip_smoke.py``
(``sha256_bound_ms``, ``rs_pass_bound_ms``, ``gf16_bound_ms``), counted
here for the whole square.
"""

from __future__ import annotations

SHARE = 512
NS = 29

# Peaks of one NVIDIA H100 SXM5 80 GB at its 700 W limit.
# Data sheet: HBM3 bandwidth 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
# Data sheet: INT8 tensor core, dense (without sparsity), 1,979 TOPS.
INT8_TENSOR_OPS_PER_S = 1979e12
# Data sheet: FP32 outside the tensor cores, 67 TFLOPS, counting an FMA as
# two operations.
FP32_FLOPS_PER_S = 67e12
# Derived, not on the data sheet: SHA-256 runs on the 32-bit integer ALUs.
# 67e12 / 2 = 33.5e12 FP32 instructions per second over 128 FP32 lanes
# per SM; an SM has 64 INT32 lanes, half as many, so 16.75e12 INT32
# instructions per second.
INT32_OPS_PER_S = FP32_FLOPS_PER_S / 4

# 32-bit integer instructions per SHA-256 compression at the least: 64
# rounds of 14 (Sigma0 and Sigma1: 3 funnel shifts and 1 three-input XOR
# each; Ch and Maj: 1 three-input logic op each; T1, e and a: 4
# three-input adds), 48 schedule steps of 10 (sigma0 and sigma1: 3
# shifts and 1 XOR each; 2 adds), and 8 adds into the state.
SHA_OPS_PER_COMPRESSION = 64 * 14 + 48 * 10 + 8


def compressions(length: int) -> int:
    """SHA-256 compressions of one message of `length` bytes."""
    return (length + 9 + 63) // 64


def sha256_work(k: int, data_root: bool = True) -> tuple[int, int]:
    """(compressions, messages) of one block's commitment:
    every EDS cell hashed once as an NMT leaf (0x00 || ns || share, 542
    bytes), the 4k trees' 2k - 1 inner nodes each (0x01 || two 90-byte
    children, 181 bytes), and the RFC-6962 tree over the 4k 90-byte roots
    (4k leaves of 91 bytes, 4k - 1 inner nodes of 65 bytes). Without
    `data_root`, the 4k axis roots alone: what verifying a repaired square
    against its committed roots needs at the least."""
    leaves = 4 * k * k
    inner = 4 * k * (2 * k - 1)
    c = leaves * compressions(1 + NS + SHARE) + inner * compressions(1 + 2 * (2 * NS + 32))
    if not data_root:
        return c, leaves + inner
    c += 4 * k * compressions(1 + 2 * NS + 32) + (4 * k - 1) * compressions(1 + 2 * 32)
    return c, leaves + inner + 4 * k + 4 * k - 1


def sha256_least_s(k: int, data_root: bool = True) -> tuple[float, str]:
    """Least time of one block's SHA-256 work (`sha256_work`): its
    compressions against the INT32 rate, or each block read once and each
    digest written once against HBM, whichever is larger; and which of the
    two bounds it."""
    c, msgs = sha256_work(k, data_root)
    ops_s = c * SHA_OPS_PER_COMPRESSION / INT32_OPS_PER_S
    bytes_s = (c * 64 + msgs * 32) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def extension_work(k: int, bits: int) -> tuple[float, float]:
    """(operations, bytes) of one square's extension as a GF(2) bit
    product: 3 passes (Q1, Q2, Q3) of k lines, each line a (bits k) x
    (bits k) 0/1 matrix times the line's bits at each of its 512 / (bits
    / 8) symbol positions, a multiply-add counted as 2. Bytes: the ODS
    read once, three quadrants written once, the matrix read once."""
    width = bits * k
    symbols = SHARE * 8 // bits
    ops = 3 * k * 2 * width * width * symbols
    nbytes = 4 * k * k * SHARE + width * width
    return float(ops), float(nbytes)


def extension_least_s(k: int, bits: int) -> tuple[float, str]:
    """Least time of one square's extension against the INT8 tensor rate
    (the nearest published rate: the card has no GF(2) unit) or HBM."""
    ops, nbytes = extension_work(k, bits)
    ops_s = ops / INT8_TENSOR_OPS_PER_S
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"
