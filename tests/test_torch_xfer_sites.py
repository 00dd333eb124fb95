"""The port's host↔device transfer ledger (`obs.xfer`) against the JAX
package's, site by site, on the CPU.

Each workload runs through both packages: a k = 4 `eds_axis_roots`, a
batched `repair_eds` at k = 4 with half the columns missing, a namespace
read (its prover's level pass and the batched search), a CMT and a PCMT
encode of a k = 4 ODS, `stream_blocks` over two k = 4 blocks, and the
one-device batched dispatch (`mesh_engine.compute_entries_batched`) of
two k = 4 squares. The set
of (site, direction) pairs each package's ledger records must be the
same, with one named exception: the CMT and PCMT encodes hash the coded
base layer where the encode left it, on the device, so the port has no
``cmt.hash_symbols`` upload (the reference brings the parity down and the
coded base up again between its two jitted stages). The port's own call
and byte counts are pinned beside the reference's; where they differ the
comment says why.

Each package keeps its own telemetry registry; a test reads each one
around its own call only.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from celestia_app_tpu.da import cmt as ref_cmt
from celestia_app_tpu.da import dah as ref_dah
from celestia_app_tpu.da import namespace_device as ref_namespace_device
from celestia_app_tpu.da import pcmt as ref_pcmt
from celestia_app_tpu.da import proof_device as ref_proof_device
from celestia_app_tpu.da import repair as ref_repair
from celestia_app_tpu.ops import nmt as ref_nmt
from celestia_app_tpu.parallel import mesh_engine as ref_mesh_engine
from celestia_app_tpu.parallel import streaming as ref_streaming
from celestia_app_tpu.utils import telemetry as ref_telemetry
from celestia_app_tpu_torch.da import cmt, dah, namespace_device, pcmt, proof_device, repair
from celestia_app_tpu_torch.obs import xfer
from celestia_app_tpu_torch.ops import nmt
from celestia_app_tpu_torch.parallel import mesh_engine, streaming
from celestia_app_tpu_torch.utils import telemetry

from test_torch_obs import FakeCuda

K = 4
_SERIES = re.compile(r'xfer\.(h2d|d2h)_(calls|bytes)\{site="([^"]+)"\}')


def ledger(registry, fn) -> dict:
    """{(site, direction): {"calls": n, "bytes": b}} that `fn` added to the
    registry's transfer counters."""
    before = registry.snapshot()["counters"]
    fn()
    after = registry.snapshot()["counters"]
    out: dict = {}
    for key, value in after.items():
        m = _SERIES.fullmatch(key)
        if m and value != before.get(key, 0):
            out.setdefault((m.group(3), m.group(1)), {})[m.group(2)] = value - before.get(key, 0)
    return out


def square_of(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, size=(k, k, 512), dtype=np.uint8)
    ods[..., :29] = 0
    ods[..., 28] = 9
    return ods


@pytest.fixture(scope="module")
def block():
    ods = square_of(K, 1)
    ref_header, ref_eds, _ = ref_dah.new_dah_from_ods(ods)
    header, eds, _ = dah.new_dah_from_ods(ods, device="cpu")
    np.testing.assert_array_equal(np.asarray(ref_eds.squares), eds.squares)
    return ods, (ref_header, ref_eds), (header, eds)


def half_columns_missing(eds_squares: np.ndarray):
    present = np.ones(eds_squares.shape[:2], dtype=bool)
    present[:, ::2] = False
    damaged = eds_squares.copy()
    damaged[~present] = 0
    return damaged, present


def workloads(block) -> dict:
    """name -> (reference call, port call), each returning its result."""
    ods, (ref_header, ref_eds), (header, eds) = block
    full = np.asarray(eds.squares)
    damaged, present = half_columns_missing(full)
    queries = [ods[0, 0, :29].tobytes(), bytes(28) + b"\x05"]
    batch = np.stack([ods, square_of(K, 2)])

    def layout(i):
        return ref_streaming._synthetic_layout(K, i)

    return {
        "axis_roots": (lambda: ref_nmt.eds_axis_roots(full[:3], [0, 1, 5], K),
                       lambda: nmt.eds_axis_roots(full[:3], [0, 1, 5], K, "cpu")),
        "repair": (lambda: ref_repair.repair_eds(damaged, present, list(ref_header.row_roots),
                                                 list(ref_header.col_roots), engine="batched"),
                   lambda: repair.repair_eds(damaged, present, list(header.row_roots),
                                             list(header.col_roots), device="cpu")),
        "namespace_read": (
            lambda: ref_namespace_device.get_namespace_data_batched(
                ref_proof_device.BlockProver(ref_eds, ref_header), queries, engine="device"),
            lambda: namespace_device.get_namespace_data_batched(
                proof_device.BlockProver(eds, header, device="cpu"), queries, device="cpu")),
        "cmt_encode": (lambda: ref_cmt.build_layers(ods, engine="device"),
                       lambda: cmt.build_layers(ods, device="cpu")),
        "pcmt_encode": (lambda: ref_pcmt.build_layers(ods, engine="device"),
                        lambda: pcmt.build_layers(ods, device="cpu")),
        "stream_blocks": (lambda: ref_streaming.stream_blocks(layout, 2, K),
                          lambda: streaming.stream_blocks(layout, 2, K, device="cpu")),
        "batched_dispatch": (
            lambda: [e.data_root for e in ref_mesh_engine.compute_entries_batched(batch)],
            lambda: [e.data_root for e in mesh_engine.compute_entries_batched(batch, device="cpu")]),
    }


# Reference pairs with no port crossing: the coded base is hashed on the
# device where the encode wrote it.
ON_THE_DEVICE = {
    "cmt_encode": {("cmt.hash_symbols", "h2d")},
    "pcmt_encode": {("cmt.hash_symbols", "h2d")},
}

# The port's own ledger at k = 4 (calls, bytes).
PORT_COUNTS = {
    # the slabs and the axis indices up (the reference pads the batch of 3
    # to 4 and its int32 indices with it: 16,400 bytes), the roots down
    "axis_roots": {("ops.roots_dispatch", "h2d"): (2, 3 * 8 * 512 + 3 * 8),
                   ("ops.roots_fetch", "d2h"): (1, 3 * 90)},
    # the square up once and down once; between them only the decode's
    # per-axis agreement bools (8 rows, 8 columns' codeword check) and the
    # axis indices of the two root reductions cross. The reference uploads
    # each decode batch and each root batch and brings every result down.
    "repair": {("ops.repair_dispatch", "h2d"): (1, 8 * 8 * 512),
               ("ops.repair_fetch", "d2h"): (3, 8 * 8 * 512 + 8 + 8),
               ("ops.roots_dispatch", "h2d"): (2, 2 * 8 * 8),
               ("ops.roots_fetch", "d2h"): (2, 2 * 8 * 90)},
    # the level pass: the square up, its 4 levels down (the reference's
    # counts); the search itself crosses nothing on the CPU
    "namespace_read": {("proof.row_levels", "h2d"): (1, 8 * 8 * 512),
                       ("proof.row_levels", "d2h"): (1, 10800)},
    # the ODS up once; the coded layer and its hash list down
    "cmt_encode": {("ldpc.encode", "h2d"): (1, 16 * 512),
                   ("ldpc.encode", "d2h"): (1, 32 * 512),
                   ("cmt.hash_symbols", "d2h"): (1, 32 * 32)},
    "pcmt_encode": {("polar.encode", "h2d"): (1, 16 * 512),
                    ("polar.encode", "d2h"): (1, 38912),
                    ("cmt.hash_symbols", "d2h"): (1, 2432)},
    # each ODS up, each data root down (the reference brings every output
    # of the pipeline down, the EDS included: 68,480 bytes)
    "stream_blocks": {("streaming.dispatch", "h2d"): (2, 2 * 4 * 4 * 512),
                      ("streaming.fetch", "d2h"): (2, 2 * 32)},
    # the batch up once, the commitments of both blocks down once (row and
    # column roots and data roots); the squares stay on the device
    "batched_dispatch": {("mesh.batched_dispatch", "h2d"): (1, 2 * 4 * 4 * 512),
                         ("mesh.batched_commitments", "d2h"): (1, 2 * (2 * 8 * 90 + 32))},
}


@pytest.mark.parametrize("name", sorted(PORT_COUNTS))
def test_sites_match_the_reference(block, name):
    ref_call, port_call = workloads(block)[name]
    ref_out = ledger(ref_telemetry, ref_call)
    port_out = ledger(telemetry, port_call)
    assert set(port_out) | ON_THE_DEVICE.get(name, set()) == set(ref_out)
    assert not set(port_out) & ON_THE_DEVICE.get(name, set())
    assert {pair: (c["calls"], c["bytes"]) for pair, c in port_out.items()} == PORT_COUNTS[name]


def test_the_workloads_agree(block):
    """The ledgers are compared over workloads that give the same bytes."""
    calls = workloads(block)
    for name in ("axis_roots", "repair", "stream_blocks", "batched_dispatch"):
        ref_call, port_call = calls[name]
        got, want = port_call(), ref_call()
        if name in ("stream_blocks", "batched_dispatch"):
            assert got == want
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for name in ("cmt_encode", "pcmt_encode"):
        ref_call, port_call = calls[name]
        assert port_call().commitments.root_hashes == ref_call().commitments.root_hashes


def test_a_card_resident_repair_crosses_only_through_the_ledger(block, monkeypatch):
    """Every tensor the ledger puts on the "device" here says it lies on a
    card (`FakeCuda`, as the probe sees a CUDA tensor), and so does every
    tensor computed from it. A repair under `no_implicit_transfers()` then
    raises at any device→host read the ledger does not mediate; the port's
    batched repair makes none, and gives the reference's square."""
    _, (ref_header, _), (header, eds) = block
    damaged, present = half_columns_missing(np.asarray(eds.squares))
    plain_to_device = xfer.to_device

    def to_card(value, site, *, device):
        return xfer._map(plain_to_device(value, site, device=device), lambda t: t.as_subclass(FakeCuda))

    monkeypatch.setattr(xfer, "to_device", to_card)
    with xfer.no_implicit_transfers():
        with pytest.raises(xfer.ImplicitTransferError):  # the probe is armed
            to_card(np.zeros(2, dtype=np.uint8), "test.probe", device="cpu").cpu()
        got = repair.repair_eds(damaged, present, list(header.row_roots), list(header.col_roots),
                                device="cpu")
    assert not isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got, np.asarray(eds.squares))
    want = ref_repair.repair_eds(damaged, present, list(ref_header.row_roots),
                                 list(ref_header.col_roots), engine="batched")
    np.testing.assert_array_equal(got, np.asarray(want))
