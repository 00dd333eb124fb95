"""The sharded block pipeline: row-sharded RS extension and NMT roots over
a (data, seq) mesh. The port of celestia_app_tpu/parallel/sharded_eds.py.

A batch of B squares is split over the mesh's ``data`` axis and the k rows
of each square over its ``seq`` axis (parallel/mesh.py). Each shard runs,
on its own device, the steps of the reference's `_local_pipeline`:

  1. row pass     — RS-extend its k/n original rows (one K2 launch; at
                    k >= 256 the 16-bit `rs.gf16_mix`);
  2. transpose 1  — from row sharding to column sharding: shard s takes
                    columns [s, s+1) * 2k/n of all k original rows;
  3. column pass  — extend each owned column over its k data symbols:
                    original columns give Q2, parity columns give Q3 (the
                    product code commutes, so this equals extending the
                    rows of Q2);
  4. column roots — hash every leaf of the owned columns ONCE (K1) and
                    reduce the column trees;
  5. transpose 2  — back to row sharding, shares and their 32-byte leaf
                    digests carried together along the byte axis;
  6. row roots    — leaf namespaces recomputed from the global row and
                    column offsets, digests reused from step 4;
  7. data root    — over the gathered 4k axis roots of every square, on
                    the mesh's lead device.

The reference runs this as one jax ``shard_map`` whose two ``all_to_all``s
ride the TPU interconnect. Here one process drives every device: each
transpose is a set of per-shard copies (``Tensor.copy_``, device to device
between cards, where torch orders the copy after the source's and the
destination's current streams; a plain on-device copy when two shards
share a device) into the receiving shard's buffer, all through `transpose`,
which parallel/multihost.py calls too with its cross-host exchange. K2 and
K1 are the same wrappers the one-device pipeline calls, launched on the
shard's device.

Launches per dispatch, for a mesh of n = data x seq shards: K2 2n (GF(2^8),
k <= 128; none in GF(2^16)); K1 n x (1 + 2 log2(2k)) plus one data-root
tree of 1 + log2(4k) on the lead device.

The result is gathered on the lead device: the EDS (B, 2k, 2k, 512), row
and column roots (B, 2k, 90) each and data roots (B, 32), byte-equal to
`da/eds.pipeline_batched` on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch.obs import xfer
from celestia_app_tpu_torch.ops import leopard, merkle, nmt, rs, rs_kernel
from celestia_app_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, Mesh

NS = appconsts.NAMESPACE_SIZE
SHARE = appconsts.SHARE_SIZE


def _leaf_ns_local(sq_local: torch.Tensor, k: int, major_start: int) -> torch.Tensor:
    """Leaf namespaces for locally owned axis trees.

    ``sq_local`` is (B_l, M_l, 2k, SHARE): M_l major-axis entries (rows or
    columns) starting at global index ``major_start``, each a full tree of
    2k leaves. A leaf keeps its share's own namespace prefix iff it lies in
    Q0 (global major index < k and minor index < k), else it takes the
    parity namespace (pkg/wrapper/nmt_wrapper.go:93-114 semantics)."""
    dev = sq_local.device
    major = major_start + torch.arange(sq_local.shape[1], device=dev)
    minor = torch.arange(2 * k, device=dev)
    in_q0 = (major[:, None] < k) & (minor[None, :] < k)  # (M_l, 2k)
    return torch.where(in_q0[None, :, :, None], sq_local[..., :NS], nmt.parity_ns(dev))


def _extend(src: torch.Tensor, dst: torch.Tensor, k: int) -> None:
    """dst <- RS parity of every (B_l, lines, k, SHARE) line of src, in
    place: one K2 launch in GF(2^8), `gf16_mix` in GF(2^16)."""
    dev = src.device
    if leopard.field_for(k) == 8:
        rs_kernel.extend_lines(((src, dst),), rs.bit_operand(k, dev))
    else:
        rs.gf16_mix(src.view(-1, k, SHARE), rs.bit_operand16(k, dev), dst.view(-1, k, SHARE))


def input_slabs(mesh: Mesh, ods_batch) -> list[list[torch.Tensor]]:
    """The pipeline's input placement: slab [d][s] of a (B, k, k, 512)
    batch holds squares [d, d+1) * B/data and rows [s, s+1) * k/seq, on
    device [d][s]. A host batch crosses through the transfer ledger
    (``mesh.sharded_dispatch``), one slab per shard; a tensor is sliced and
    copied device to device."""
    n_data, n_seq = mesh.shape[DATA_AXIS], mesh.shape[SEQ_AXIS]
    b, k = int(ods_batch.shape[0]), int(ods_batch.shape[1])
    if b % n_data:
        raise ValueError(f"batch {b} must divide over data axis {n_data}")
    if k % n_seq:
        raise ValueError(f"seq axis {n_seq} must divide square size {k}")
    b_l, r_l = b // n_data, k // n_seq
    grid = []
    for d, row in enumerate(mesh.devices):
        slabs = []
        for s, dev in enumerate(row):
            part = ods_batch[d * b_l:(d + 1) * b_l, s * r_l:(s + 1) * r_l]
            if isinstance(part, torch.Tensor):
                slabs.append(part.to(dev, non_blocking=True))
            else:
                slabs.append(xfer.to_device(np.ascontiguousarray(part), "mesh.sharded_dispatch", device=dev))
        grid.append(slabs)
    return grid


def _validate(ods_batch) -> tuple[int, int]:
    if isinstance(ods_batch, torch.Tensor):
        dtype_ok = ods_batch.dtype == torch.uint8
    else:
        ods_batch = np.asarray(ods_batch)
        dtype_ok = ods_batch.dtype == np.uint8
    if ods_batch.ndim != 4 or not dtype_ok or ods_batch.shape[0] < 1 or \
            tuple(ods_batch.shape[2:]) != (ods_batch.shape[1], SHARE):
        raise ValueError(f"ODS batch must be (B, k, k, {SHARE}) uint8, got {tuple(ods_batch.shape)}")
    return int(ods_batch.shape[0]), int(ods_batch.shape[1])


def row_pass(slab: torch.Tensor, k: int) -> torch.Tensor:
    """Step 1 on one shard: (B_l, k/n, k, SHARE) original rows on its device
    -> (B_l, k/n, 2k, SHARE), the rows extended in place."""
    top = torch.empty((*slab.shape[:2], 2 * k, SHARE), dtype=torch.uint8, device=slab.device)
    top[:, :, :k].copy_(slab)
    _extend(top[:, :, :k], top[:, :, k:], k)
    return top


def column_pass(eds_cols: torch.Tensor, k: int, col_start: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 3 and 4 on one shard: (B_l, c_l, 2k, SHARE) owned columns,
    column-major, rows < k filled -> (column roots (B_l, c_l, 90), the
    columns packed with their leaf digests (B_l, c_l, 2k, SHARE + 32)); the
    parity rows are written in place."""
    b_l, c_l, two_k = eds_cols.shape[:3]
    _extend(eds_cols[:, :, :k], eds_cols[:, :, k:], k)
    mins, maxs, vs = nmt.leaf_nodes(
        _leaf_ns_local(eds_cols, k, col_start).reshape(b_l * c_l, two_k, NS),
        eds_cols.reshape(b_l * c_l, two_k, SHARE))
    roots = nmt.roots_from_leaf_nodes(mins, maxs, vs).reshape(b_l, c_l, -1)
    return roots, torch.cat([eds_cols, vs.reshape(b_l, c_l, two_k, 32)], dim=3)


def row_roots_of(back: torch.Tensor, k: int, row_start: int) -> torch.Tensor:
    """Step 6 on one shard: (B_l, c_l, 2k, SHARE + 32) owned rows with their
    leaf digests -> (B_l, c_l, 90) row roots, the leaf namespaces recomputed
    from the global offsets and the digests reused."""
    b_l, c_l, two_k = back.shape[:3]
    row_ns = _leaf_ns_local(back[..., :SHARE], k, row_start).reshape(b_l * c_l, two_k, NS)
    roots = nmt.roots_from_leaf_nodes(row_ns, row_ns, back[..., SHARE:].reshape(b_l * c_l, two_k, 32))
    return roots.reshape(b_l, c_l, -1)


def piece(src: torch.Tensor, s: int, width: int) -> torch.Tensor:
    """What a source shard (B_l, lines, 2k, bytes) sends to seq shard s in
    a transpose: its ``width`` columns [s, s+1) * width."""
    return src[:, :, s * width:(s + 1) * width]


def place(dst: torch.Tensor, s_src: int, p: torch.Tensor) -> None:
    """Write the piece `p` of seq shard `s_src` into a destination shard
    (B_l, width, 2k, bytes), transposed: its lines become the
    destination's minor entries [s_src, s_src+1) * lines."""
    lines = p.shape[1]
    dst[:, :, s_src * lines:(s_src + 1) * lines].copy_(p.transpose(1, 2), non_blocking=True)


def transpose(srcs: dict, dsts: dict, exchange=None) -> None:
    """One all_to_all over the seq axis. `srcs` and `dsts` map (d, s) to
    the shards held here; destination (d, s) takes `piece` s of every
    source (d, s2) of its data row, through `place`. Pairs held here are
    copied (device to device between cards); ``exchange(srcs, dsts)``, when
    given, moves the pieces of the pairs with one end held elsewhere."""
    for (d, s), dst in dsts.items():
        for (d2, s2), src in srcs.items():
            if d2 == d:
                place(dst, s2, piece(src, s, dst.shape[1]))
    if exchange is not None:
        exchange(srcs, dsts)


def sharded_pipeline(mesh: Mesh, ods_batch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, k, k, 512) uint8 batch (numpy, or a tensor) -> (eds, row_roots,
    col_roots, data_roots) on the mesh's lead device: (B, 2k, 2k, 512),
    (B, 2k, 90) twice and (B, 32), with B split over ``data`` and the rows
    of each square over ``seq``. Raises ValueError when the seq extent does
    not divide k or the data extent does not divide B."""
    b, k = _validate(ods_batch)
    n_data, n = mesh.shape[DATA_AXIS], mesh.shape[SEQ_AXIS]
    b_l, c_l = b // n_data, 2 * k // n
    two_k = 2 * k
    shards = [(d, s) for d in range(n_data) for s in range(n)]
    dev = {(d, s): mesh.devices[d][s] for d, s in shards}
    slabs = input_slabs(mesh, ods_batch)
    # 1. row pass: each shard extends its k/n original rows
    tops = {(d, s): row_pass(slabs[d][s], k) for d, s in shards}
    del slabs

    # 2. transpose 1: shard s gathers columns [s*c_l, (s+1)*c_l) of all k
    #    original rows, column-major: (B_l, 2k/n cols, 2k, SHARE), rows < k
    cols = {g: torch.empty((b_l, c_l, two_k, SHARE), dtype=torch.uint8, device=dev[g]) for g in shards}
    transpose(tops, cols)
    del tops
    # 3, 4. column pass; column leaves hashed once, column roots from them
    col_roots, packed = {}, {}
    for d, s in shards:
        col_roots[d, s], packed[d, s] = column_pass(cols.pop((d, s)), k, s * c_l)

    # 5. transpose 2: shares and digests packed along the byte axis, so each
    #    pair of shards exchanges one piece; shard s takes rows
    #    [s*c_l, (s+1)*c_l) of every column
    backs = {g: torch.empty((b_l, c_l, two_k, SHARE + 32), dtype=torch.uint8, device=dev[g]) for g in shards}
    transpose(packed, backs)
    del packed
    # 6. row roots; the EDS rows and every root gathered on the lead device
    lead = mesh.lead
    eds = torch.empty((b, two_k, two_k, SHARE), dtype=torch.uint8, device=lead)
    row_roots = torch.empty((b, two_k, appconsts.NMT_ROOT_SIZE), dtype=torch.uint8, device=lead)
    col_roots_all = torch.empty_like(row_roots)
    for d, s in shards:
        back = backs.pop((d, s))
        at = (slice(d * b_l, (d + 1) * b_l), slice(s * c_l, (s + 1) * c_l))
        row_roots[at].copy_(row_roots_of(back, k, s * c_l), non_blocking=True)
        eds[at].copy_(back[..., :SHARE], non_blocking=True)
        col_roots_all[at].copy_(col_roots[d, s], non_blocking=True)

    # 7. the data roots over rowRoots || colRoots of every square
    data_roots = merkle.merkle_root_pow2(torch.cat([row_roots, col_roots_all], dim=1))
    return eds, row_roots, col_roots_all, data_roots
