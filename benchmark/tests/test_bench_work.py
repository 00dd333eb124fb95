"""The work counts and least times against a count made by hashing, and
against the arithmetic of the port's chip_smoke.py that they copy."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import work
from benchmark.reference import eds as ref_eds
from benchmark.reference import nmt, sha256


@pytest.mark.parametrize("k", [2, 4, 8])
def test_sha256_compressions_equal_those_of_a_hashed_block(k):
    counted = {"compressions": 0, "messages": 0}

    def counting(msgs: torch.Tensor) -> torch.Tensor:
        counted["compressions"] += msgs.shape[0] * sha256.blocks_per_message(msgs.shape[1])
        counted["messages"] += msgs.shape[0]
        return sha256.digest_hashlib(msgs)

    ods = np.random.default_rng(k).integers(0, 256, (1, k, k, 512), dtype=np.uint8)
    c = ref_eds.commit(torch.from_numpy(ods), hash_fn=counting)
    assert work.sha256_work(k) == (counted["compressions"], counted["messages"])
    # a repair verifies the 4k axis roots and computes no data root
    counted.update(compressions=0, messages=0)
    nmt.axis_roots(c.eds, counting)
    assert work.sha256_work(k, data_root=False) == (counted["compressions"], counted["messages"])


def test_least_times_copy_the_chip_smoke_arithmetic():
    # chip_smoke.rs_pass_bound_ms(128): 0.06944868795957554 ms of operations per pass
    assert work.extension_least_s(128, 8) == (pytest.approx(3 * 0.06944868795957554e-3, rel=1e-12), "operations")
    # chip_smoke.gf16_bound_ms(k): 3.3335 / 26.668 ms at k = 256 / 512, operations
    assert work.extension_least_s(256, 16)[0] == pytest.approx(3.3335e-3, rel=1e-4)
    assert work.extension_least_s(512, 16) == (pytest.approx(26.668e-3, rel=1e-4), "operations")
    # chip_smoke.sha256_bound_ms(9, 65536): 0.04873530841791045 ms for the k = 128 leaves alone
    leaves = 4 * 128 * 128 * 9
    assert leaves * work.SHA_OPS_PER_COMPRESSION / work.INT32_OPS_PER_S == pytest.approx(0.04873530841791045e-3)


@pytest.mark.parametrize("k", [128, 256, 512])
def test_both_layers_are_bound_by_operations_at_the_cells_sizes(k):
    bits = 8 if k <= 128 else 16
    assert work.extension_least_s(k, bits)[1] == "operations"
    assert work.sha256_least_s(k)[1] == work.sha256_least_s(k, data_root=False)[1] == "operations"
