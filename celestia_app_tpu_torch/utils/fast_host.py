"""Host SHA-256 of many equal-length messages, through hashlib: the port of
celestia_app_tpu/utils/fast_host._sha_many. The codecs' host yardstick
(chip_smoke.py, the tests); the port's own hashing runs on the card."""

from __future__ import annotations

import hashlib

import numpy as np


def sha_many(preimages: np.ndarray) -> np.ndarray:
    """(N, L) u8 -> (N, 32) u8, hashlib over contiguous memoryview slices."""
    n, length = preimages.shape
    buf = memoryview(np.ascontiguousarray(preimages).reshape(-1).data)
    out = np.empty((n, 32), dtype=np.uint8)
    sha = hashlib.sha256
    for i in range(n):
        out[i] = np.frombuffer(sha(buf[i * length:(i + 1) * length]).digest(), np.uint8)
    return out
