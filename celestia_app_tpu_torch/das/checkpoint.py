"""DASer checkpoint: durable sampling progress for a light node.

Copied from celestia_app_tpu/das/checkpoint.py: the same file format, so
a checkpoint written by either package resumes in the other.

The celestia-node DASer persists a checkpoint (SampleFrom / NetworkHead /
Failed map) so a restarted daemon resumes where it left off instead of
resampling the chain; this is that record, with the same fsync-before-
replace discipline every per-height artifact in this repo uses
(chain/reactor.py commit records, consensus.py sign state). File format
is normative — docs/FORMATS.md §7.3.

`halted` is the terminal record: a verified bad-encoding fraud proof (or
an operator decision) condemned a height, and this node must not follow
the chain past it until the checkpoint is cleared by hand.
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass
class Checkpoint:
    sample_from: int = 1  # first height NOT yet durably sampled
    network_head: int = 0  # highest header this node has verified
    failed: dict[int, int] = dataclasses.field(default_factory=dict)
    # height -> attempts; retried on later sweeps
    halted: dict | None = None
    # {"height": H, "reason": "bad-encoding"|..., "data_root": hex}

    def to_json(self) -> dict:
        return {
            "version": 1,
            "sample_from": self.sample_from,
            "network_head": self.network_head,
            "failed": {str(h): n for h, n in sorted(self.failed.items())},
            "halted": self.halted,
        }

    @staticmethod
    def from_json(doc: dict) -> "Checkpoint":
        if int(doc.get("version", 1)) != 1:
            raise ValueError(f"unknown checkpoint version {doc.get('version')}")
        return Checkpoint(
            sample_from=int(doc.get("sample_from", 1)),
            network_head=int(doc.get("network_head", 0)),
            failed={int(h): int(n)
                    for h, n in (doc.get("failed") or {}).items()},
            halted=doc.get("halted"),
        )


class CheckpointStore:
    """One checkpoint file, written atomically (tmp + fsync + replace) —
    a crash mid-save leaves the previous checkpoint intact, so the DASer
    can only ever UNDER-claim progress, never skip heights."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> Checkpoint:
        if not os.path.exists(self.path):
            return Checkpoint()
        with open(self.path) as f:
            return Checkpoint.from_json(json.load(f))

    def save(self, cp: Checkpoint) -> None:
        self.save_doc(cp.to_json())

    def save_doc(self, doc: dict) -> None:
        """Write an already-snapshotted ``Checkpoint.to_json()`` doc —
        callers that guard their checkpoint with a lock snapshot under
        the lock and pay the fsync OUTSIDE it (blocking-under-lock)."""
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
