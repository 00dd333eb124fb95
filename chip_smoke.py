#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (celestia_app_tpu_torch) on one
NVIDIA GPU (written for the H100, sm_90a).

Run from the repository root, on a machine with a card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the exit code is not 0 and the
final line is never printed):

1. print the card's name and power limit, the torch and CUDA versions;
   build both kernels from celestia_app_tpu_torch/csrc/ with nvcc, in
   parallel, and print the build seconds and the register report;
2. kernel K1 (SHA-256 compression) against its plain version on the card,
   at the main path's message lengths, N = 65,536 and a ragged N = 1,000,
   plus digests against hashlib;
3. kernel K2 (RS extension of lines, int8 tensor-core product) against its
   plain version on the card at every k = 1, 2, 4, ..., 128, on random,
   all-0xFF and all-zero squares: the row launch into a fresh tensor, the
   in-place column launch, the two in-place launches of the square
   extension (Q1 and Q2, then Q3) and the whole extended square;
4. the main path at full width: a seeded block of txs and PFBs through
   square.build (k = 128), shares_to_ods and new_dah_from_ods on cuda, with
   both launch counters read around it (19 K1 and 2 K2 launches); the data
   root against the port's own CPU path, and the reference golden hashes;
5. the proof and read plane on the same block, on cuda: the block cache
   (EdsCache.get_or_compute, then a hit with no launch), the row and
   column provers (9 K1 launches each, row levels equal to the CPU path),
   batched blob commitments (K1 launches as the MMR plan says, equal to
   hashlib and to the commitments read off the row trees), share proofs of
   every blob and tx proofs of every tx and PFB verified against the data
   root (a seeded sample equal to the host proofs), cells at each
   quadrant's corners through the column prover, and batched namespace
   reads of every present and some absent namespaces against the host
   scan, each verified against the DAH; one `proof_plane` line;
6. times with CUDA events after warm-up: the block, each kernel at the main
   path's shapes, each plain version, K2's library yardsticks (fp16
   torch.matmul and torch._int_mm of the same product) and the two-launch
   extension; the tensor-core instructions in K2's SASS (cuobjdump); and a
   torch.profiler trace of the block for its device busy time by kernel.

The line before the last is {"kernels": [...]}, with each kernel's launches
summed over the paths driven in phases 4 and 5 and split by path; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits with code 2 before any of this.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from celestia_app_tpu_torch import appconsts, cuda_build
from celestia_app_tpu_torch.da import (
    blob,
    commitment,
    commitment_device,
    dah,
    edscache,
    eds,
    namespace,
    namespace_data,
    namespace_device,
    proof,
    proof_device,
    square,
)
from celestia_app_tpu_torch.ops import leopard, rs, rs_kernel, sha256, sha256_kernel

SEED = 0
K_MAIN = 128
K1_CHECK_LENGTHS = (542, 181, 91, 65)  # NMT leaf, NMT inner, Merkle leaf, Merkle inner
K1_CHECK_COUNTS = (65536, 1000)  # the leaf level at k = 128, and a ragged N
K2_CHECK_KS = (1, 2, 4, 8, 16, 32, 64, 128)
K2_PATTERNS = ("random", "ones", "zeros")  # all-0xFF puts every s32 sum at its largest
HOST_PROOF_SAMPLE = 16  # share ranges checked against the hashlib proofs
ABSENT_NAMESPACES = 8

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet, dense
# rates). The card has no SHA or GF(2) unit:
# K1 runs on the 32-bit integer ALUs, 64 lanes per SM against 128 for
# float32, so its peak is a quarter of the 67 TFLOP/s float32 figure (which
# counts an FMA as 2); K2's bit products are held against the int8 tensor
# core rate, the nearest published rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
INT8_TENSOR_OPS_PER_S = 1979e12
# 32-bit integer instructions per SHA-256 block at the least: 64 rounds of
# 14 (Sigma0 and Sigma1: 3 funnel shifts + 1 three-input XOR each; Ch and
# Maj: 1 three-input logic op each; T1, e and a: 4 three-input adds), 48
# schedule steps of 10 (sigma0 and sigma1: 3 shifts + 1 XOR each; 2 adds),
# and 8 adds into the state.
SHA_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8

MIN_DAH_HASH = bytes.fromhex("3d96b7d238e7e0456f6af8e7cdf0a67bd6cf9c2089ecb559c659dcaa1f880353")
MAX_128X128_HASH = bytes.fromhex("0bd3abeeacfbb0b92dfbdac4a154868e3c4e79666f7fcf6c620bb90dd3a0dcf0")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got: torch.Tensor, want: torch.Tensor, mask: int) -> int:
    """Largest |got - want| over the elements, read as unsigned `mask` words."""
    diff = (got.to(torch.int64) & mask) - (want.to(torch.int64) & mask)
    return int(diff.abs().max().item())


def sha256_bound_ms(nblocks: int, n: int) -> tuple[float, str]:
    ops_s = nblocks * n * SHA_OPS_PER_BLOCK / INT32_OPS_PER_S
    bytes_s = (nblocks * 64 * n + 32 * n) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def rs_pass_bound_ms(k: int) -> tuple[float, str]:
    ops_s = 2 * (8 * k) ** 2 * k * appconsts.SHARE_SIZE / INT8_TENSOR_OPS_PER_S
    bytes_s = (2 * k * k * appconsts.SHARE_SIZE + rs_kernel.padded(k) ** 2) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def realistic_block(seed: int, max_square: int) -> tuple[list[bytes], list[square.PfbEntry]]:
    """Seeded mempool contents that overfill a max_square x max_square
    square: plain txs of 150-400 bytes, and PFBs of 1-3 blobs each with
    sizes log-uniform from one share (100 B) to 512 KB, under 40 version-0
    namespaces."""
    rng = np.random.default_rng(seed)
    txs = [rng.bytes(int(rng.integers(150, 400))) for _ in range(300)]
    namespaces = [namespace.Namespace.v0(rng.bytes(10)) for _ in range(40)]
    capacity = max_square * max_square * appconsts.CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
    pfbs, total = [], 0
    while total < 1.1 * capacity:
        blobs = []
        for _ in range(int(rng.integers(1, 4))):
            size = int(math.exp(rng.uniform(math.log(100), math.log(512 * 1024))))
            ns = namespaces[int(rng.integers(0, len(namespaces)))]
            blobs.append(blob.Blob(ns, rng.bytes(size)))
            total += size
        pfbs.append(square.PfbEntry(rng.bytes(int(rng.integers(250, 450))), tuple(blobs)))
    return txs, pfbs


def extend_plain(ods: torch.Tensor, operand: torch.Tensor) -> torch.Tensor:
    """The extended square through K2's plain version: Q1 from the rows of
    Q0, Q2 from its columns, Q3 from the rows of Q2."""
    q1 = rs_kernel.extend_pass_ref(ods, operand)
    q2 = rs_kernel.extend_pass_ref(ods.transpose(0, 1), operand).transpose(0, 1)
    q3 = rs_kernel.extend_pass_ref(q2, operand)
    return torch.cat([torch.cat([ods, q1], dim=1), torch.cat([q2, q3], dim=1)], dim=0)


def square_of(pattern: str, k: int, rng: np.random.Generator, dev: torch.device) -> torch.Tensor:
    shape = (k, k, appconsts.SHARE_SIZE)
    if pattern == "random":
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    return torch.full(shape, 0xFF if pattern == "ones" else 0, dtype=torch.uint8, device=dev)


def check_sha256(dev: torch.device, rng: np.random.Generator) -> int:
    worst = 0
    for msg_len in K1_CHECK_LENGTHS:
        for n in K1_CHECK_COUNTS:
            msgs = torch.from_numpy(rng.integers(0, 256, (n, msg_len), dtype=np.uint8)).to(dev)
            blocks = sha256.pack_blocks(msgs)
            got = sha256_kernel.compress_words(blocks)
            want = sha256_kernel.compress_words_ref(blocks)
            torch.cuda.synchronize()
            err = max_abs_err(got, want, 0xFFFFFFFF)
            require(err == 0, f"K1 differs from its plain version at L={msg_len} N={n}")
            worst = max(worst, err)
            digests = sha256.digest_bytes(got).cpu().numpy()
            host = msgs.cpu().numpy()
            for i in (0, 1, n - 1):
                require(digests[i].tobytes() == hashlib.sha256(host[i].tobytes()).digest(),
                        f"K1 digest {i} differs from hashlib at L={msg_len} N={n}")
            emit("k1_check", msg_len=msg_len, n=n, nblocks=blocks.shape[0], max_abs_err=err)
    return worst


def check_rs(dev: torch.device, rng: np.random.Generator) -> int:
    worst = 0
    for k in K2_CHECK_KS:
        operand = rs.bit_operand(k, dev)
        require(torch.equal(operand[: 8 * k, : 8 * k].cpu(), torch.from_numpy(leopard.bit_matrix(k)).to(torch.uint8)),
                f"K2 operand differs from leopard.bit_matrix({k})")
        errs = {}
        for pattern in K2_PATTERNS:
            ods = square_of(pattern, k, rng, dev)
            want = extend_plain(ods, operand)
            got = {"rows": rs_kernel.extend_pass(ods, operand)}
            cols = torch.zeros_like(want)
            cols[:k, :k] = ods
            rs_kernel.extend_lines(((cols[:k, :k].transpose(0, 1), cols[k:, :k].transpose(0, 1)),), operand)
            got["cols_in_place"] = cols[k:, :k]
            eds = torch.zeros_like(want)
            eds[:k, :k] = ods
            rs_kernel.extend_eds(eds, "rows_cols", operand)
            got["q1"], got["q2"] = eds[:k, k:].clone(), eds[k:, :k].clone()
            rs_kernel.extend_eds(eds, "q3", operand)
            got["q3"] = eds[k:, k:]
            got["square"] = rs.extend_square_fn(k, dev)(ods)
            torch.cuda.synchronize()
            for name, g in got.items():
                w = {"rows": want[:k, k:], "cols_in_place": want[k:, :k], "q1": want[:k, k:],
                     "q2": want[k:, :k], "q3": want[k:, k:], "square": want}[name]
                err = max_abs_err(g, w, 0xFF)
                require(err == 0, f"K2 {name} differs from its plain version at k={k} on the {pattern} square")
                errs[f"{pattern}/{name}"] = err
        worst = max(worst, *errs.values())
        emit("k2_check", k=k, max_abs_err=max(errs.values()), checks=len(errs))
    return worst


def int_mm_ms(a: torch.Tensor, bits: torch.Tensor) -> float:
    """Time of one torch._int_mm (int8 x int8 -> int32) of the same product
    as a K2 pass: (8k x 8k) @ (8k x k*512), the bits of all k lines side by
    side, in the column-major layout of the right operand that cuBLAS
    takes for int8."""
    x = bits.permute(1, 0, 2).reshape(bits.shape[1], -1).to(torch.int8)
    x = x.t().contiguous().t()
    a8 = a.to(torch.int8).contiguous()
    got = torch._int_mm(a8, x)
    want = torch.matmul(a.to(torch.float32), x.to(torch.float32))
    require(torch.equal(got.to(torch.float32), want), "torch._int_mm differs from the float32 product")
    return cuda_ms(lambda: torch._int_mm(a8, x), reps=20)


def k2_sass_counts() -> dict:
    """Tensor-core instructions in K2's library, by SASS mnemonic
    (cuobjdump -sass): warpgroup products are ?GMMA (IGMMA for int8),
    warp-level ones ?MMA."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(cuda_build.library_path("rs_extend"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    counts: dict[str, int] = {}
    for op in re.findall(r"\b([A-Z]*MMA)\b", sass):
        counts[op] = counts.get(op, 0) + 1
    require(sum(n for op, n in counts.items() if op.endswith("GMMA")) > 0,
            f"no warpgroup MMA instruction in K2's SASS: {counts}")
    return counts


def reset_counts() -> None:
    sha256_kernel.compress_words.launches = 0
    rs_kernel.extend_lines.launches = 0


def read_counts() -> dict:
    return {"sha256_compress": sha256_kernel.compress_words.launches,
            "rs_extend_lines": rs_kernel.extend_lines.launches}


def main_path(dev: torch.device) -> dict:
    upper = appconsts.SQUARE_SIZE_UPPER_BOUND
    t0 = time.perf_counter()
    txs, pfbs = realistic_block(SEED, upper)
    sq = square.build(txs, pfbs, upper, appconsts.SUBTREE_ROOT_THRESHOLD)
    ods = dah.shares_to_ods(sq.share_bytes())
    build_s = time.perf_counter() - t0
    require(sq.size == K_MAIN, f"the block built a k={sq.size} square, not {K_MAIN}")
    n_blobs = sum(len(e.blobs) for e in sq.pfbs)
    emit("block", k=sq.size, txs=len(sq.txs), pfbs=len(sq.pfbs), blobs=n_blobs,
         namespaces=len({b.namespace for e in sq.pfbs for b in e.blobs}),
         blob_bytes=sum(len(b.data) for e in sq.pfbs for b in e.blobs),
         layout_s=build_s)

    reset_counts()
    d, ext, root = dah.new_dah_from_ods(ods)
    launches = read_counts()
    # 1 leaf launch + log2(2k) inner levels + 1 Merkle leaf launch +
    # log2(4k) Merkle levels; 2 RS launches (rows and columns of Q0, rows of Q2)
    want_k1 = 2 + int(math.log2(2 * K_MAIN)) + int(math.log2(4 * K_MAIN))
    require(launches["sha256_compress"] == want_k1, f"K1 launches {launches} != {want_k1}")
    require(launches["rs_extend_lines"] == 2, f"K2 launches {launches} != 2")
    d.validate_basic()
    require(root == d.hash(), "device data root differs from the host hash of the DAH")

    t0 = time.perf_counter()
    d_cpu, ext_cpu, root_cpu = dah.new_dah_from_ods(ods, device="cpu")
    cpu_s = time.perf_counter() - t0
    require(root == root_cpu, "data root differs from the port's CPU path")
    require(d.row_roots == d_cpu.row_roots and d.col_roots == d_cpu.col_roots,
            "axis roots differ from the port's CPU path")
    require(np.array_equal(ext.squares, ext_cpu.squares), "EDS differs from the port's CPU path")

    ns1 = namespace.Namespace.v0(bytes([1]) * 10)
    constant = dah.shares_to_ods([ns1.raw + b"\xff" * (appconsts.SHARE_SIZE - 29)] * (K_MAIN * K_MAIN))
    _, _, golden = dah.new_dah_from_ods(constant)
    require(golden == MAX_128X128_HASH, f"128x128 constant square root {golden.hex()}")
    require(dah.min_data_root() == MIN_DAH_HASH, "min data root differs from the golden hash")
    emit("main_path", data_root=root.hex(), launches=launches, cpu_path_s=cpu_s,
         golden_128=golden.hex(), golden_min=MIN_DAH_HASH.hex())
    return {"ods": ods, "square": sq, "data_root": root, "launches": launches}


def timed(fn):
    """(fn(), host seconds), the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def proof_plane(dev: torch.device, main: dict, rng: np.random.Generator) -> dict:
    """The block cache, provers, commitments, proofs and namespace reads on
    the main path's block. Returns the launch counts of each counted run."""
    ods, sq, data_root = main["ods"], main["square"], main["data_root"]
    k = sq.size
    log2_2k = int(math.log2(2 * k))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counted = {}

    # 1. the block cache: one encode, then a hit with no launch
    cache = edscache.EdsCache()
    reset_counts()
    entry, cache_miss_s = timed(lambda: cache.get_or_compute(ods))
    counted["cache_miss"] = read_counts()
    require(counted["cache_miss"] == main["launches"],
            f"cache miss launches {counted['cache_miss']} != the main path's {main['launches']}")
    require(entry.data_root == data_root, "cached data root differs from the main path's")
    reset_counts()
    again = cache.get_or_compute(ods)
    hit_counts = read_counts()
    require(again is entry and cache.hits == 1 and cache.misses == 1, "second get_or_compute was no hit")
    require(hit_counts == {"sha256_compress": 0, "rs_extend_lines": 0}, f"cache hit launched {hit_counts}")
    require(cache.lookup_root(data_root) is entry, "lookup_root did not find the entry")

    # 2. the row and column provers: 1 + log2(2k) K1 launches each
    reset_counts()
    prover, row_prover_s = timed(entry.get_prover)
    counted["row_prover"] = read_counts()
    reset_counts()
    col_prover, col_prover_s = timed(entry.get_col_prover)
    counted["col_prover"] = read_counts()
    for name in ("row_prover", "col_prover"):
        require(counted[name] == {"sha256_compress": 1 + log2_2k, "rs_extend_lines": 0},
                f"{name} launches {counted[name]} != {1 + log2_2k} K1")
    cpu_levels = proof_device.levels_to_host(proof_device.row_levels(entry.eds.squares, device="cpu"))
    require(all(np.array_equal(g, w) for lv, wlv in zip(prover.levels, cpu_levels) for g, w in zip(lv, wlv)),
            "row levels differ from the port's CPU path")
    top = col_prover.levels[-1]
    require(tuple(top[0][c, 0].tobytes() + top[1][c, 0].tobytes() + top[2][c, 0].tobytes()
                  for c in range(2 * k)) == entry.dah.col_roots,
            "column prover's tree roots differ from the column roots")
    eds_dev = torch.from_numpy(entry.eds.squares).to(dev)
    level_pass_ms = cuda_ms(lambda: proof_device.row_levels(eds_dev, dev), reps=10)
    device_profile("level_pass_profile", lambda: proof_device.row_levels(eds_dev, dev), level_pass_ms)
    levels_dev = proof_device.row_levels(eds_dev, dev)
    download_ms = cuda_ms(lambda: proof_device.levels_to_host(levels_dev), reps=5)
    levels_mb = sum(a.nbytes for lv in prover.levels for a in lv) / 1e6

    # 3. batched blob commitments: 1 + log2(s) K1 launches per distinct subtree size s
    blobs = [b for e in sq.pfbs for b in e.blobs]
    threshold = appconsts.SUBTREE_ROOT_THRESHOLD
    _, groups = commitment_device.plan(blobs, threshold)
    want_k1 = sum(1 + int(math.log2(s)) for s in groups)
    reset_counts()
    got = commitment_device.commitments_device(blobs, threshold)
    counted["commitments"] = read_counts()
    require(counted["commitments"] == {"sha256_compress": want_k1, "rs_extend_lines": 0},
            f"commitment launches {counted['commitments']} != {want_k1} K1 from the plan")
    host, hashlib_s = timed(lambda: commitment.create_commitments(blobs, threshold))
    from_eds = [prover.commitment_from_eds(sq, i, j, threshold)
                for i, e in enumerate(sq.pfbs) for j in range(len(e.blobs))]
    require(got == host == from_eds, "commitments differ between the card, hashlib and the row trees")
    device_s = min(timed(lambda: commitment_device.commitments_device(blobs, threshold))[1] for _ in range(3))

    # 4. share proofs of every blob, tx proofs of every tx and PFB
    ranges = [(proof.blob_share_range(sq, i, j), b.namespace.raw)
              for i, e in enumerate(sq.pfbs) for j, b in enumerate(e.blobs)]
    n_tx = len(sq.txs) + len(sq.pfbs)
    t0 = time.perf_counter()
    blob_proofs = [prover.prove_shares(lo, hi, ns) for (lo, hi), ns in ranges]
    blob_prove_s = time.perf_counter() - t0
    tx_proofs = [prover.prove_tx(sq, i) for i in range(n_tx)]
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    require(all(p.verify(data_root) and p.all_shares_in_namespace() for p in blob_proofs),
            "a blob share proof does not verify")
    require(all(p.verify(data_root) for p in tx_proofs), "a tx proof does not verify")
    verify_s = time.perf_counter() - t0
    sample = [ranges[int(i)][0] for i in rng.choice(len(ranges), HOST_PROOF_SAMPLE // 2, replace=False)]
    for _ in range(HOST_PROOF_SAMPLE - len(sample)):
        lo = int(rng.integers(0, k * k))
        sample.append((lo, int(rng.integers(lo + 1, min(k * k, lo + 3 * k) + 1))))
    for lo, hi in sample:
        ns = ods[lo // k, lo % k, :29].tobytes()
        require(dataclasses.astuple(prover.prove_shares(lo, hi, ns))
                == dataclasses.astuple(proof.new_share_inclusion_proof(entry.eds, entry.dah, lo, hi, ns)),
                f"share proof of [{lo}, {hi}) differs from the host proof")
    corners = [(r, c) for r in (0, k - 1, k, 2 * k - 1) for c in (0, k - 1, k, 2 * k - 1)]
    for r, c in corners:
        share, pf = col_prover.prove_cell(c, r)
        ns = share[:29] if r < k and c < k else namespace.PARITY_NS_RAW
        require(share == entry.eds.squares[r, c].tobytes() and pf.verify(entry.dah.col_roots[c], [(ns, share)]),
                f"column proof of cell ({r}, {c}) does not verify")

    # 5. batched namespace reads against the host scan
    present = sorted({b.namespace.raw for b in blobs})
    absent = []
    while len(absent) < ABSENT_NAMESPACES:
        ns = namespace.Namespace.v0(rng.bytes(10)).raw
        if ns not in present and ns not in absent:
            absent.append(ns)
    queries = present + absent
    reads = namespace_device.get_namespace_data_batched(prover, queries)
    scan, scan_s = timed(lambda: [namespace_data.get_namespace_data(prover, q) for q in queries])
    for q, nd, want in zip(queries, reads, scan):
        require(dataclasses.astuple(nd) == dataclasses.astuple(want), f"namespace read {q.hex()} differs from the host scan")
        require(namespace_data.verify_namespace_data(entry.dah, q, nd), f"namespace read {q.hex()} does not verify")
    require([bool(nd.shares) for nd in reads] == [True] * len(present) + [False] * len(absent),
            "namespace presence differs from the block's blobs")
    batched_s = min(timed(lambda: namespace_device.get_namespace_data_batched(prover, queries))[1]
                    for _ in range(3))

    emit("proof_plane", k=k, launches=counted, cache_hit_launches=hit_counts,
         cache_miss_s=cache_miss_s, row_prover_s=row_prover_s, col_prover_s=col_prover_s,
         level_pass_ms=level_pass_ms, levels_download_ms=download_ms, levels_mb=levels_mb,
         commitments=len(blobs), subtree_sizes=sorted(groups), commitments_device_ms=device_s * 1e3,
         commitments_hashlib_ms=hashlib_s * 1e3,
         proofs=len(blob_proofs) + len(tx_proofs), proofs_per_s=(len(blob_proofs) + len(tx_proofs)) / prove_s,
         blob_proofs_per_s=len(blob_proofs) / blob_prove_s,
         tx_proofs_per_s=len(tx_proofs) / (prove_s - blob_prove_s),
         verify_per_s=(len(blob_proofs) + len(tx_proofs)) / verify_s, host_proofs_checked=len(sample),
         cells_checked=len(corners), namespaces_present=len(present), namespaces_absent=len(absent),
         namespace_batched_ms=batched_s * 1e3, namespace_host_scan_ms=scan_s * 1e3,
         peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    return counted


def device_profile(phase: str, fn, wall_ms: float, reps: int = 3) -> None:
    """Device time of fn() by kernel, from a torch.profiler trace of `reps`
    calls after one warm-up; the busy share is held against `wall_ms`, the
    unprofiled time of one call. Host-to-device copies are counted apart:
    a copy from pageable host memory holds the host until it is done."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    ops = h2d = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
            ops += 1
            h2d += "HtoD" in e.name
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit(phase, device_busy_ms=busy_ms, device_ops_per_call=ops / reps, h2d_copies_per_call=h2d / reps,
         idle_share=1 - busy_ms / wall_ms, top_ms=[[name[:72], ms] for name, ms in top])


def timings(dev: torch.device, ods_np: np.ndarray, rng: np.random.Generator) -> dict:
    k = ods_np.shape[0]
    ods = torch.from_numpy(ods_np.copy()).to(dev)

    block_ms = cuda_ms(lambda: eds.pipeline(ods, dev), reps=10)
    t0 = time.perf_counter()
    for _ in range(5):
        dah.new_dah_from_ods(ods_np)
    dah_ms = (time.perf_counter() - t0) / 5 * 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dah.new_dah_from_ods(ods_np)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    emit("block_time", k=k, pipeline_ms=block_ms, new_dah_from_ods_ms=dah_ms, peak_mib=peak_mib)
    device_profile("block_profile", lambda: eds.pipeline(ods, dev), block_ms)

    leaves = torch.from_numpy(rng.integers(0, 256, ((2 * k) ** 2, 542), dtype=np.uint8)).to(dev)
    leaf_blocks = sha256.pack_blocks(leaves)  # (9, 16, 65536) at k = 128
    nblocks, _, n = leaf_blocks.shape
    k1_ms = cuda_ms(lambda: sha256_kernel.compress_words(leaf_blocks), reps=50)
    k1_plain_ms = cuda_ms(lambda: sha256_kernel.compress_words_ref(leaf_blocks), reps=3, warmup=1)
    k1_bound, k1_by = sha256_bound_ms(nblocks, n)

    operand = rs.bit_operand(k, dev)
    k2_ms = cuda_ms(lambda: rs_kernel.extend_pass(ods, operand), reps=50)
    k2_plain_ms = cuda_ms(lambda: rs_kernel.extend_pass_ref(ods, operand), reps=5, warmup=1)
    # Library yardstick: the GF(2) product alone as one torch.matmul of 0/1
    # fp16 operands (exact: sums <= 8k = 1024 fit fp16's 11-bit mantissa).
    a = operand[: 8 * k, : 8 * k]
    bits = rs_kernel.bytes_to_bits(ods)  # (k, 8k, 512)
    b16, bits16 = a.to(torch.float16), bits.to(torch.float16)
    k2_lib_ms = cuda_ms(lambda: torch.matmul(b16, bits16), reps=20)
    k2_bound, k2_by = rs_pass_bound_ms(k)
    emit("kernel_time", k1_shape=[nblocks, 16, n], k2_shape=list(ods.shape))
    extend = rs.extend_square_fn(k, dev)
    emit("k2_detail", k=k, extend_two_launch_ms=cuda_ms(lambda: extend(ods), reps=50),
         int_mm_ms=int_mm_ms(a, bits), sass=k2_sass_counts())
    return {
        "k1": (k1_ms, k1_plain_ms, k1_bound, k1_by, None),
        "k2": (k2_ms, k2_plain_ms, k2_bound, k2_by, k2_lib_ms),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), capability=list(torch.cuda.get_device_capability(0)))

    t0 = time.perf_counter()
    logs = cuda_build.build()
    emit("build", seconds=time.perf_counter() - t0, built=sorted(logs),
         ptxas=[ln.strip() for log in logs.values() for ln in log.splitlines()
                if "Compiling entry" in ln or "registers" in ln or "spill" in ln])

    rng = np.random.default_rng(SEED)
    k1_err = check_sha256(dev, rng)
    k2_err = check_rs(dev, rng)
    main = main_path(dev)
    by_path = {"main_path": main["launches"], **proof_plane(dev, main, rng)}
    t = timings(dev, main["ods"], rng)

    rows = []
    for key, name, source, replaces, counter, err in (
        ("k1", "sha256_compress", "celestia_app_tpu_torch/csrc/sha256.cu",
         "celestia_app_tpu/ops/sha256_pallas.py:45", "sha256_compress", k1_err),
        ("k2", "rs_extend_lines", "celestia_app_tpu_torch/csrc/rs_extend.cu",
         "celestia_app_tpu/ops/rs_pallas.py:33", "rs_extend_lines", k2_err),
    ):
        ms, plain_ms, bound_ms, bound_by, library_ms = t[key]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(counts[counter] for counts in by_path.values()),
            "launches_by_path": {path: counts[counter] for path, counts in by_path.items()},
            "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
