"""Batched block production: plan B squares, extend them in ONE dispatch.

Port of celestia_app_tpu/chain/producer.py. A per-block produce loop pays
one dispatch and one full-EDS host copy per block; this module batches
the produce side:

- ``plan_block_squares`` speculatively partitions a priority-ordered
  candidate tx list into the next ``n_blocks`` block layouts by running
  the SAME deterministic greedy accounting the proposer runs
  (da/square.build): block i's square is built from the txs blocks
  0..i-1 did not admit. When the ante admits every candidate (the normal
  case — pool txs already passed CheckTx), each planned square is
  byte-identical to the one ``prepare_proposal`` will construct.

- ``warm_block_batch`` groups the planned squares by size and extends
  each group in ONE batched dispatch on the app's device
  (parallel/mesh_engine.compute_entries_batched: `da/eds.pipeline_batched`,
  two K2 launches and one K1 pass for the whole group; 19 K1 at k = 128
  whatever the batch; the sharded pipeline over the app's ``mesh`` when
  one is active for the size), inserting DEVICE-RESIDENT entries into the app's
  content-addressed EDS cache. The subsequent per-block produce rounds
  hit those entries, so the extend→commit→prover-warm chain hands device
  arrays — never bytes — between stages, and ``da.extend_runs`` stays at
  exactly one per height (paid inside the batch).

The batch is a PREFETCH, not a consensus change: every committed block
still goes through the unchanged prepare→process→finalize→commit path,
so batched and per-block production commit identical block and app
hashes by construction. A plan the ante later disagrees with (a candidate
turned invalid between planning and proposing) merely misses the cache
and pays a normal per-block extend, counted ``producer.plan_misses``.
Wired in behind ``Node.produce_blocks_batched``. The port has no host
engine, so there is no early return for one: an App on ``device="cpu"``
runs the same batched pass through the plain kernel versions.
"""

from __future__ import annotations

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch.chain.state import InfiniteGasMeter
from celestia_app_tpu_torch.da import blob as blob_mod
from celestia_app_tpu_torch.da import dah as dah_mod
from celestia_app_tpu_torch.da import square as square_mod
from celestia_app_tpu_torch.da.square import PfbEntry
from celestia_app_tpu_torch.utils import telemetry


def plan_block_squares(app, raw_txs: list[bytes],
                       n_blocks: int) -> list[square_mod.Square]:
    """Partition ``raw_txs`` (priority order, a mempool reap) into up to
    ``n_blocks`` consecutive speculative block layouts. Deterministic,
    state-read-only (square-size params); undecodable candidates are
    skipped exactly as admission would drop them. Stops early when the
    candidates run out — trailing empty blocks are not planned (an empty
    square is one cached entry for ALL empty heights anyway)."""
    threshold = appconsts.subtree_root_threshold(app.app_version)
    ctx = app._ctx(app.store.branch(), InfiniteGasMeter(), check=False)
    max_sq = app.max_effective_square_size(ctx)

    normals: list[bytes] = []
    pfbs: list[tuple[bytes, PfbEntry]] = []
    for raw in raw_txs:
        try:
            btx = blob_mod.try_unmarshal_blob_tx(raw)
        except ValueError:
            continue  # admission would reject it; keep the plan aligned
        if btx is not None:
            pfbs.append((raw, PfbEntry(btx.tx, btx.blobs)))
        else:
            normals.append(raw)

    plans: list[square_mod.Square] = []
    for _ in range(max(0, n_blocks)):
        if not normals and not pfbs:
            break
        sq = square_mod.build(normals, [e for _, e in pfbs], max_sq,
                              threshold)
        plans.append(sq)
        kept_n = set(sq.txs)
        kept_p = {e.tx for e in sq.pfbs}
        normals = [r for r in normals if r not in kept_n]
        pfbs = [(r, e) for r, e in pfbs if e.tx not in kept_p]
    return plans


def warm_block_batch(app, plans: list[square_mod.Square]) -> int:
    """Extend every planned square in as few dispatches as sizes allow
    (one per size bucket) and seed the app's EDS cache with the
    resulting device-resident entries. Returns how many entries were
    inserted. Only the default codec has a batched device program; other
    schemes skip (their per-block encode path is unchanged)."""
    from celestia_app_tpu_torch.da import edscache as edscache_mod
    from celestia_app_tpu_torch.parallel import mesh_engine

    if getattr(app, "codec", None) is not None \
            and app.codec.name != "rs2d-nmt":
        return 0
    import numpy as np

    by_k: dict[int, list] = {}
    for sq in plans:
        ods = dah_mod.shares_to_ods(sq.share_bytes())
        key = edscache_mod.cache_key(ods)
        if app.eds_cache.get(key) is not None:
            telemetry.incr("producer.plan_cached")
            continue  # an identical square is already resident
        by_k.setdefault(sq.size, []).append((key, ods))

    inserted = 0
    for k, group in sorted(by_k.items()):
        # dedup within the group (two planned empty/equal squares are
        # one content-addressed entry)
        seen: dict[bytes, object] = {}
        for key, ods in group:
            seen.setdefault(key, ods)
        batch = np.stack(list(seen.values()))
        entries = mesh_engine.compute_entries_batched(batch, device=app.device,
                                                      mesh=getattr(app, "mesh", None))
        for key, entry in zip(seen.keys(), entries):
            app.eds_cache.put(key, entry)
            inserted += 1
    telemetry.incr("producer.blocks_planned", len(plans))
    return inserted
