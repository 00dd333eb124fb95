"""SHA-256 (FIPS 180-4) of many equal-length messages at once, in plain
torch int64 arithmetic on any device, and the same through hashlib.

`digest` is what the reference hashes with after a run, on the card; the
tests hold it to `digest_hashlib` (and so to hashlib) on the CPU.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
_M = 0xFFFFFFFF

# messages hashed together: their int64 schedule takes 64 x 8 B each
CHUNK = 1 << 20


def blocks_per_message(length: int) -> int:
    """64-byte blocks of a padded message of `length` bytes (0x80, zeros,
    and the 8-byte bit length)."""
    return (length + 9 + 63) // 64


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M


def _pad(msgs: torch.Tensor) -> torch.Tensor:
    """(N, L) uint8 -> (N, blocks, 16) int64 big-endian words."""
    n, length = msgs.shape
    nb = blocks_per_message(length)
    buf = torch.zeros((n, nb * 64), dtype=torch.uint8, device=msgs.device)
    buf[:, :length] = msgs
    buf[:, length] = 0x80
    bit_len = (8 * length).to_bytes(8, "big")
    buf[:, -8:] = torch.tensor(list(bit_len), dtype=torch.uint8, device=msgs.device)
    b = buf.view(n, nb, 16, 4)
    return ((b[..., 0].to(torch.int64) << 24) | (b[..., 1].to(torch.int64) << 16)
            | (b[..., 2].to(torch.int64) << 8) | b[..., 3].to(torch.int64))


def _compress(state: list[torch.Tensor], block: torch.Tensor) -> list[torch.Tensor]:
    """One compression of every message's (16,) block words into `state`."""
    w = [block[:, i] for i in range(16)]
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        big_s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _M) & g)
        t1 = (h + big_s1 + ch + _K[t] + w[t]) & _M
        big_s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & _M
        d, c, b, a = c, b, a, (t1 + big_s0 + maj) & _M
    return [(s + v) & _M for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def digest(msgs: torch.Tensor) -> torch.Tensor:
    """(N, L) uint8 messages -> (N, 32) uint8 digests, on their device."""
    n = msgs.shape[0]
    out = torch.empty((n, 32), dtype=torch.uint8, device=msgs.device)
    for lo in range(0, n, CHUNK):
        words = _pad(msgs[lo:lo + CHUNK])
        m = words.shape[0]
        state = [torch.full((m,), h, dtype=torch.int64, device=msgs.device) for h in _H0]
        for i in range(words.shape[1]):
            state = _compress(state, words[:, i])
        st = torch.stack(state, dim=1)  # (m, 8)
        shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=msgs.device)
        out[lo:lo + m] = ((st.unsqueeze(-1) >> shifts) & 0xFF).reshape(m, 32).to(torch.uint8)
    return out


def digest_hashlib(msgs: torch.Tensor) -> torch.Tensor:
    """`digest` through hashlib, one message at a time (the tests' witness)."""
    host = msgs.cpu().numpy()
    out = np.frombuffer(b"".join(hashlib.sha256(m.tobytes()).digest() for m in host), dtype=np.uint8)
    return torch.from_numpy(out.reshape(-1, 32).copy()).to(msgs.device)
