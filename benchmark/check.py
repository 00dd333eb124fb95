"""The comparison that decides ``correct``: what the timed path produced
for each sampled block against the reference's commitment of the same
ODS, byte for byte.

Every number compared is a count of things that differ, and its limit is
0: the extension, the NMT roots and the data root are exact. A sampled
block whose outputs could not be read counts as unchecked.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import eds as ref_eds
from benchmark.reference import nmt, sha256

LIMITS = {
    "eds_shares_differ": 0,  # 512-byte shares of the 2k x 2k EDS, all four quadrants
    "axis_roots_differ": 0,  # of the 2k row and 2k column NMT roots
    "data_roots_differ": 0,
    "blocks_unchecked": 0,  # sampled blocks whose outputs could not be read
}
# A withheld-square cell's own: of the calls on a sampled block's hand-over
# with one root altered (traffic.Driver.altered_roots), those the entry
# answered instead of raising. The EDS comparison cannot see a repair that
# skips its root verification, since honest hand-overs pass either way.
HANDOVER_LIMITS = {"altered_roots_accepted": 0}


@dataclasses.dataclass
class Outputs:
    """What the program produced for one block, on the host."""

    eds: np.ndarray  # (2k, 2k, 512) uint8
    row_roots: list[bytes]
    col_roots: list[bytes]
    data_root: bytes


def read_outputs(entry, square: torch.Tensor | None = None) -> Outputs:
    """The outputs of an rs2d entry: its commitments, and its square, or
    `square` where the square was kept apart (a copy of a device entry's,
    which crosses to the host here, after the window)."""
    eds = square.cpu().numpy() if square is not None else np.asarray(entry.eds.squares)
    return Outputs(eds, list(entry.dah.row_roots), list(entry.dah.col_roots), bytes(entry.data_root))


def _rows(t: torch.Tensor) -> list[bytes]:
    return [r.tobytes() for r in t.cpu().numpy()]


# reference squares committed at once: (2k)^2 x 512 bytes each
GROUP_BYTES = 512 << 20


def compare(blocks: list[tuple[Outputs | None, np.ndarray]], device,
            hash_fn: nmt.HashFn = sha256.digest) -> list[dict[str, int]]:
    """For each (what the program produced, the ODS it was handed), the
    counts of what differs from the reference commitment of that ODS,
    computed on `device` a group of squares at a time."""
    out: list[dict[str, int]] = []
    if not blocks:
        return out
    k = blocks[0][1].shape[0]
    per_group = max(1, GROUP_BYTES // (4 * k * k * 512))
    for lo in range(0, len(blocks), per_group):
        group = blocks[lo:lo + per_group]
        odss = torch.from_numpy(np.stack([ods for _, ods in group])).to(device)
        want = ref_eds.commit(odss, hash_fn=hash_fn)
        for i, (got, _) in enumerate(group):
            out.append(_differences(got, want, i))
        del want, odss
    return out


def _differences(got: Outputs | None, want: ref_eds.Commitment, i: int) -> dict[str, int]:
    if got is None:
        return {"blocks_unchecked": 1}
    want_eds = want.eds[i].cpu().numpy()
    counts = {"eds_shares_differ": int(np.any(got.eds != want_eds, axis=-1).sum())
              if got.eds.shape == want_eds.shape else want_eds.shape[0] * want_eds.shape[1]}
    rows, cols = _rows(want.row_roots[i]), _rows(want.col_roots[i])
    counts["axis_roots_differ"] = (sum(a != b for a, b in zip(got.row_roots, rows))
                                   + sum(a != b for a, b in zip(got.col_roots, cols))
                                   + abs(len(got.row_roots) - len(rows)) + abs(len(got.col_roots) - len(cols)))
    counts["data_roots_differ"] = int(got.data_root != want.data_root[i].cpu().numpy().tobytes())
    return counts


def total(per_block: list[dict[str, int]]) -> dict[str, int]:
    out = {name: 0 for name in LIMITS}
    for counts in per_block:
        for name, n in counts.items():
            out[name] += n
    return out


def passed(totals: dict[str, int], limits: dict[str, int] = LIMITS) -> bool:
    return all(totals[name] <= limit for name, limit in limits.items())
