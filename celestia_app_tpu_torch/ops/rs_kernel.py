"""Kernel K2: GF(2^8) Reed-Solomon extension of lines of shares, and its
plain version.

`extend_lines` launches csrc/rs_extend.cu on CUDA tensors and takes the
plain version on CPU tensors. It replaces the TPU kernel
celestia_app_tpu/ops/rs_pallas.py:_extend_pass_kernel: for each line of k
data shards (512 bytes each) the k parity shards, parity_bits =
(A @ data_bits) mod 2 per byte column, A = leopard.bit_matrix(k) (8k x 8k).
Bits of a byte column are LSB-first, bit 8*shard + b, as in the
reference's ops/rs.py:bytes_to_bits.

A travels as the kernel's operand: (kpad, kpad) uint8 0/1, kpad =
max(128, 8k), A in its top-left 8k x 8k block and zeros elsewhere
(ops/rs.py builds it once per (k, device)). A launch takes one or two line
groups, each a (source, destination) pair of (lines, k, 512) uint8 views,
or (blocks, lines, k, 512) for a batch of squares, whose block, line and
shard strides are any positive multiples of 512: the kernel reads the
sources and writes the destinations in place.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from celestia_app_tpu_torch import appconsts, cuda_build

SHARE = appconsts.SHARE_SIZE
MAX_K = 128  # the GF(2^8) code covers 256 total shards
TILE = 128  # rows and K of the operand are padded to this
MAX_GROUPS = 2


def padded(k: int) -> int:
    """Side of K2's operand for a k-shard code: 8k rounded up to a tile."""
    return max(TILE, 8 * k)


def bytes_to_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., n, S) uint8 -> (..., 8n, S) uint8 bits, LSB-first in each byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (x.unsqueeze(-2) >> shifts[:, None]) & 1  # (..., n, 8, S)
    return bits.reshape(*x.shape[:-2], 8 * x.shape[-2], x.shape[-1])


def bits_to_bytes(b: torch.Tensor) -> torch.Tensor:
    """(..., 8n, S) integer bits -> (..., n, S) uint8, LSB-first."""
    n = b.shape[-2] // 8
    b = b.reshape(*b.shape[:-2], n, 8, b.shape[-1]).to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=b.device))[:, None]
    return (b * weights).sum(dim=-2).to(torch.uint8)


def extend_pass_ref(x: torch.Tensor, operand: torch.Tensor) -> torch.Tensor:
    """Plain version: (..., lines, k, 512) uint8 data shards, any strides
    and leading dimensions -> (..., lines, k, 512) parity. float32 0/1
    operands with torch.matmul are exact: each dot product sums at most
    8k <= 1024 < 2^24 ones."""
    k = x.shape[-2]
    a = operand[: 8 * k, : 8 * k].to(torch.float32)
    acc = torch.matmul(a, bytes_to_bits(x).to(torch.float32))  # (lines, 8k, S)
    return bits_to_bytes(acc.to(torch.int32) & 1)


def _check_operand(operand: torch.Tensor, k: int, device: torch.device) -> None:
    side = padded(k)
    if operand.dtype != torch.uint8 or operand.shape != (side, side):
        raise cuda_build.KernelValueError(
            f"operand must be ({side}, {side}) uint8, got {tuple(operand.shape)} {operand.dtype}")
    if not operand.is_contiguous():
        raise cuda_build.KernelValueError("operand must be contiguous")
    if operand.device != device:
        raise cuda_build.KernelValueError(f"operand on {operand.device}, lines on {device}")


def _layout(view: torch.Tensor, role: str) -> tuple[int, int, int, int, int, int, int]:
    """(first share slot, blocks, block stride, lines, line stride, k,
    shard stride) of a (lines, k, 512) or (blocks, lines, k, 512) line
    view, in 512-byte share slots of its storage (one block of stride 0
    for a 3-D view)."""
    if view.dtype != torch.uint8 or view.dim() not in (3, 4) or view.shape[-1] != SHARE:
        raise cuda_build.KernelValueError(f"{role} must be (lines, k, {SHARE}) or (blocks, lines, k, {SHARE}) "
                                          f"uint8, got {tuple(view.shape)} {view.dtype}")
    blocks, block_stride = (view.shape[0], view.stride(0)) if view.dim() == 4 else (1, 0)
    lines, k, _ = view.shape[-3:]
    line_stride, shard_stride, byte_stride = view.stride()[-3:]
    if blocks == 1:
        block_stride = 0
    if byte_stride != 1 or view.storage_offset() % SHARE:
        raise cuda_build.KernelValueError(f"{role}: the bytes of a share must be contiguous and share-aligned")
    strides = (line_stride, shard_stride) + ((block_stride,) if blocks > 1 else ())
    if min(strides) < SHARE or any(st % SHARE for st in strides):
        raise cuda_build.KernelValueError(
            f"{role}: block, line and shard strides must be positive multiples of {SHARE}, got {view.stride()}")
    return (view.storage_offset() // SHARE, blocks, block_stride // SHARE, lines, line_stride // SHARE,
            k, shard_stride // SHARE)


def _slots(layout: tuple[int, int, int, int, int, int, int]) -> np.ndarray:
    first, blocks, block_stride, lines, line_stride, k, shard_stride = layout
    return (first + np.arange(blocks)[:, None, None] * block_stride
            + np.arange(lines)[None, :, None] * line_stride
            + np.arange(k)[None, None, :] * shard_stride).ravel()


@functools.lru_cache(maxsize=256)
def _disjoint(a: tuple, b: tuple) -> bool:
    """Whether two line views of one storage share no share slot."""
    return not np.intersect1d(_slots(a), _slots(b)).size


@functools.lru_cache(maxsize=256)
def _no_self_overlap(a: tuple) -> bool:
    return np.unique(_slots(a)).size == a[1] * a[3] * a[5]


def _check_groups(groups) -> int:
    """Validates the line groups of one launch and returns k."""
    if not 1 <= len(groups) <= MAX_GROUPS:
        raise cuda_build.KernelValueError(f"a launch takes 1 to {MAX_GROUPS} line groups, got {len(groups)}")
    views = []
    for src, dst in groups:
        s, d = _layout(src, "source"), _layout(dst, "destination")
        if src.shape != dst.shape:
            raise cuda_build.KernelValueError(f"source {tuple(src.shape)} and destination {tuple(dst.shape)} differ")
        views.append((src, s, False))
        views.append((dst, d, True))
    k = groups[0][0].shape[-2]
    if any(src.shape[-2] != k for src, _ in groups):
        raise cuda_build.KernelValueError("all line groups of a launch must have the same k")
    if k & (k - 1) or not 1 <= k <= MAX_K:
        raise cuda_build.KernelValueError(f"k must be a power of two <= {MAX_K}, got {k}")
    dev = groups[0][0].device
    if any(v.device != dev for v, _, _ in views):
        raise cuda_build.KernelValueError("all lines of a launch must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise cuda_build.KernelValueError(f"unsupported device {dev}")
    for i, (a, la, a_dst) in enumerate(views):
        if a_dst and not _no_self_overlap(la):
            raise cuda_build.KernelValueError("a destination overlaps itself")
        for b, lb, b_dst in views[i + 1:]:
            if not (a_dst or b_dst):
                continue
            same = a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
            if same and not _disjoint(la, lb):
                raise cuda_build.KernelValueError("a destination overlaps a source or another destination")
    return k


def _entry():
    fn = cuda_build.load("rs_extend").rs_extend_lines
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def extend_lines(groups, operand: torch.Tensor) -> None:
    """Writes the parity of every source line into its destination, in
    place: `groups` is a sequence of one or two (source, destination)
    pairs of (lines, k, 512) or (blocks, lines, k, 512) uint8 views;
    destinations overlap nothing else of the launch.

    On CUDA tensors this is one launch of K2, counted in
    ``extend_lines.launches``; on CPU tensors it is the plain version."""
    groups = tuple(groups)
    k = _check_groups(groups)
    dev = groups[0][0].device
    _check_operand(operand, k, dev)
    if dev.type == "cpu":
        parity = [extend_pass_ref(src, operand) for src, _ in groups]
        for (_, dst), p in zip(groups, parity):
            dst.copy_(p)
        return
    desc = (ctypes.c_longlong * (10 * len(groups)))()
    for g, (src, dst) in enumerate(groups):
        s, d = _layout(src, "source"), _layout(dst, "destination")
        desc[10 * g: 10 * g + 10] = [src.data_ptr(), dst.data_ptr(), SHARE * s[4], SHARE * s[6],
                                     SHARE * d[4], SHARE * d[6], s[3], s[1], SHARE * s[2], SHARE * d[2]]
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(desc, len(groups), operand.data_ptr(), k, stream)
    if err != 0:
        raise cuda_build.KernelLaunchError(f"rs_extend_lines launch failed: CUDA error {err}")
    cuda_build.count_launch(extend_lines)


extend_lines.launches = 0


def extend_pass(x: torch.Tensor, operand: torch.Tensor) -> torch.Tensor:
    """(k, k, 512) uint8 data shards per row -> (k, k, 512) uint8 parity in
    a fresh tensor: one launch of K2 over k contiguous lines."""
    if x.dtype != torch.uint8 or x.dim() != 3 or x.shape != (x.shape[0], x.shape[0], SHARE):
        raise cuda_build.KernelValueError(f"x must be (k, k, {SHARE}) uint8, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise cuda_build.KernelValueError("x must be contiguous")
    out = torch.empty_like(x)
    extend_lines(((x, out),), operand)
    return out


def extend_eds(eds: torch.Tensor, launch: str, operand: torch.Tensor) -> None:
    """One of the two in-place launches that extend the square in
    eds[:k, :k], or every square of a (B, 2k, 2k, 512) batch in
    eds[:, :k, :k]: "rows_cols" (rows of Q0 -> Q1, columns of Q0 -> Q2,
    read and written through transposed views) or "q3" (rows of Q2 -> Q3)."""
    n = eds.shape[-2]
    if (eds.dtype != torch.uint8 or eds.dim() not in (3, 4) or eds.shape[-3:] != (n, n, SHARE) or n % 2
            or not eds.is_contiguous()):
        raise cuda_build.KernelValueError(f"eds must be a contiguous (2k, 2k, {SHARE}) or (B, 2k, 2k, {SHARE}) "
                                          f"uint8 tensor, got {tuple(eds.shape)} {eds.dtype}")
    k = n // 2
    rows, cols = eds.dim() - 3, eds.dim() - 2  # the square's axes in the views
    if launch == "rows_cols":
        q0 = eds[..., :k, :k, :]
        groups = ((q0, eds[..., :k, k:, :]),
                  (q0.transpose(rows, cols), eds[..., k:, :k, :].transpose(rows, cols)))
    elif launch == "q3":
        groups = ((eds[..., k:, :k, :], eds[..., k:, k:, :]),)
    else:
        raise cuda_build.KernelValueError(f"launch must be 'rows_cols' or 'q3', got {launch!r}")
    extend_lines(groups, operand)
