"""Kernel K1: batched SHA-256 compression, and its plain PyTorch version.

`compress_words` launches csrc/sha256.cu on a CUDA tensor and takes the
plain version `compress_words_ref` on a CPU tensor. It replaces the TPU
kernel celestia_app_tpu/ops/sha256_pallas.py:_kernel.

torch has no uint32 add, shift or not, so words travel as int32 bit
patterns: the kernel reinterprets them as uint32, and the plain version
emulates uint32 arithmetic in int64, masked to 32 bits after every add and
shift.
"""

from __future__ import annotations

import ctypes

import torch

from celestia_app_tpu_torch import cuda_build
from celestia_app_tpu_torch.ops.sha256_consts import H0_WORDS, K_WORDS

_M32 = 0xFFFFFFFF


def _doubled(x: torch.Tensor) -> torch.Tensor:
    """x | x << 32 for x in [0, 2^32): bits n..n+31 of the result, for any
    n < 32, are x rotated right by n. The top bits are no word's, so every
    sum of rotations is masked before it is used."""
    return x | (x << 32)


def _sigma(x: torch.Tensor, r1: int, r2: int, s: int) -> torch.Tensor:
    """The message schedule's sigma: rotr(x, r1) ^ rotr(x, r2) ^ (x >> s)."""
    x2 = _doubled(x)
    return ((x2 >> r1) ^ (x2 >> r2) ^ (x >> s)) & _M32


def _big_sigma(x: torch.Tensor, r1: int, r2: int, r3: int) -> torch.Tensor:
    """The round's Sigma: rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3)."""
    x2 = _doubled(x)
    return ((x2 >> r1) ^ (x2 >> r2) ^ (x2 >> r3)) & _M32


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def compress_words_ref(blocks: torch.Tensor) -> torch.Tensor:
    """Plain version: (nblocks, 16, N) int32 big-endian words -> (8, N)
    int32 state (FIPS 180-4 compression of every block in turn from H0).
    Words are int64 in [0, 2^32); a sum is masked where a shift reads it."""
    nblocks, _, n = blocks.shape
    words = blocks.to(torch.int64) & _M32
    state = [torch.full((n,), h, dtype=torch.int64, device=blocks.device) for h in H0_WORDS]
    for blk in range(nblocks):
        w = [words[blk, i] for i in range(16)]
        a, b, c, d, e, f, g, h = state
        for i in range(64):
            if i >= 16:
                s0 = _sigma(w[(i - 15) % 16], 7, 18, 3)
                s1 = _sigma(w[(i - 2) % 16], 17, 19, 10)
                w[i % 16] = (w[i % 16] + s0 + w[(i - 7) % 16] + s1) & _M32
            ch = g ^ (e & (f ^ g))
            t1 = h + _big_sigma(e, 6, 11, 25) + ch + (w[i % 16] + K_WORDS[i])
            maj = (a & b) | (c & (a | b))
            t2 = _big_sigma(a, 2, 13, 22) + maj
            h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
        state = [(s + v) & _M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]
    return _to_int32(torch.stack(state))


def _entry():
    fn = cuda_build.load("sha256").sha256_compress
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def compress_words(blocks: torch.Tensor) -> torch.Tensor:
    """(nblocks, 16, N) int32 big-endian words -> (8, N) int32 state.

    On a CUDA tensor this launches K1 and counts the launch in
    ``compress_words.launches``; on a CPU tensor it is the plain version."""
    if blocks.dtype != torch.int32:
        raise cuda_build.KernelTypeError(f"blocks must be int32 words, got {blocks.dtype}")
    if blocks.dim() != 3 or blocks.shape[1] != 16:
        raise cuda_build.KernelValueError(f"blocks must be (nblocks, 16, N), got {tuple(blocks.shape)}")
    nblocks, _, n = blocks.shape
    if nblocks == 0 or n == 0:
        raise cuda_build.KernelValueError(f"nothing to compress: {tuple(blocks.shape)}")
    if not blocks.is_contiguous():
        raise cuda_build.KernelValueError("blocks must be contiguous")
    if blocks.device.type == "cpu":
        return compress_words_ref(blocks)
    if blocks.device.type != "cuda":
        raise cuda_build.KernelValueError(f"unsupported device {blocks.device}")
    out = torch.empty((8, n), dtype=torch.int32, device=blocks.device)
    fn = _entry()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(blocks.data_ptr(), out.data_ptr(), nblocks, n, stream)
    if err != 0:
        raise cuda_build.KernelLaunchError(f"sha256_compress launch failed: CUDA error {err}")
    cuda_build.count_launch(compress_words)
    return out


compress_words.launches = 0
