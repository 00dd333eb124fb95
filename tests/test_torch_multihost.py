"""The port's multi-host pipeline (parallel/multihost) on the CPU: two
worker processes of two seq shards each, joined by a gloo process group,
against the reference's one-device pipeline on the same seeded workload
(``default_rng(1234)``)."""

from __future__ import annotations

import jax
import numpy as np

from celestia_app_tpu.da import eds as ref_eds
from celestia_app_tpu_torch.parallel import multihost


def test_two_host_mesh_pipeline_matches_the_reference():
    out = multihost.spawn_dryrun(k=8, batch=2, num_processes=2, devices_per_host=2, device="cpu",
                                 timeout_s=300.0)
    assert out["global_devices"] == 4 and out["mesh"] == {"data": 1, "seq": 4}
    assert out["all_hosts_match_oracle"] is True
    assert out["exchanged_bytes"] > 0  # the transposes crossed between the hosts
    with jax.default_device(jax.devices("cpu")[0]):
        want = [np.asarray(ref_eds.jitted_pipeline(8)(o)[3]).tobytes().hex()
                for o in multihost._workload(8, 2)]
    assert out["host_data_roots"] == [want, want]
