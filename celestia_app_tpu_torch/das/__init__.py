"""DAS plane: sample-proof serving (full nodes) + DASer daemon (light
nodes) — the celestia-node DASer analog over this framework's DA core.
Port of celestia_app_tpu/das, with the reference's exports.

Server plane: das/server.py (SampleCore + routes + standalone service)
with das/packs.py static proof packs behind /das/pack*, and the blob read
plane (das/blob_server.py over das/blob_packs.py).
Client plane: das/daser.py (DASer) over das/checkpoint.py persistence.
"""

from celestia_app_tpu_torch.das.checkpoint import Checkpoint, CheckpointStore
from celestia_app_tpu_torch.das.daser import DASer, DASerConfig, PeerSet
from celestia_app_tpu_torch.das.packs import PackError, PackStore
from celestia_app_tpu_torch.das.server import (
    SampleCore,
    SampleError,
    SampleService,
    route_das,
)

__all__ = [
    "Checkpoint",
    "CheckpointStore",
    "DASer",
    "DASerConfig",
    "PackError",
    "PackStore",
    "PeerSet",
    "SampleCore",
    "SampleError",
    "SampleService",
    "route_das",
]
