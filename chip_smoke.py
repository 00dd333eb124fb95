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
   extension (Q1 and Q2, then Q3) and the whole extended square; with
   the two operands of one seeded random erasure pattern's decode (the
   fused matrix held against the generator times the inverse); in the
   repair's own calls on a (2k, 2k, 512) batch of rows and of columns;
   and in the FWHT decode of a pattern with more than k present, also
   against the host decoder;
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
6. the repair plane on the same block, on cuda: a seeded half of the
   columns withheld and repaired through Rs2dNmtCodec.repair (the ODS) and
   repair_eds (the EDS), equal to the honest square and to the CPU path,
   with 4 K2 and 2 x 9 K1 launches each; a k = 32 crossword mask that needs
   more than one sweep, equal to the scalar engine, with the launches its
   mask implies (every pattern group through K2, none on the host); a
   flipped parity cell committed under a blind DAH (eds_axis_roots, 18
   K1), caught by repair_eds as BadEncodingError at its row with the cell
   missing (4 K2, 9 K1) and with the cell present outside the use set (6
   K2: the row is inconsistent and takes the FWHT decode through K2), and
   a BEFP that verify_befp accepts on the card while an honest block's is
   refused; 64 seeded light
   clients of 16 samples each through sample_block, all verified; wall
   times, the card's busy share of the repair and the peak memory; one
   `repair_plane` line;
7. batched signature admission on the same block, on cuda: the proposer's
   batch at the v3 square cap (1,024 MsgSends signed by 64 seeded
   accounts, the block's PFBs as signed BlobTxs carrying its blobs and
   their commitments, and seeded adversarial raws whose verdicts are known
   by construction: flipped bits, a wrong account number, off-curve
   pubkeys, r = 0 and r = n on the card; s >= n, high-S, short
   signatures, undecodable envelopes, junk, unknown accounts and
   duplicates dropped before it; a few legacy-framed txs) through
   chain/admission.prevalidate. It requires the honest lane count
   verified and exactly their keys cached, every adversarial lane that
   reaches the card rejected, no error, no below-batch and no scalar lane,
   one dispatch per MAX_DISPATCH lanes, the commitment half in the K1
   launches of its MMR plan (21) and equal to hashlib and the proof
   plane's, the card's mask equal to the CPU path's on every lane and to
   _py_verify on the adversarial lanes and a seeded honest sample, and a
   repeat that computes nothing; then dispatch times by lane count, the G
   table's build and upload, _prep and _py_verify per lane, a
   torch.profiler trace of one dispatch and the peak memory; one
   `admission_plane` line;
8. the two other codecs on the same ODS, on cuda, for cmt-ldpc and
   pcmt-polar each: compute_entry cold (every code table derived and
   uploaded) and warm, with the K1 launches of the layer plan (4 for CMT,
   29 for PCMT at k = 128), the data root and every layer equal to the
   host yardstick (numpy encode_host and hashlib), times, copies and peak
   memory; the frozen k = 4 and 8 roots and the empty-block roots;
   ldpc.encode / polar.encode against encode_host and the peel of a
   seeded quarter-erased base layer, clean and with a flipped symbol,
   against peel_host (bytes, known, sweeps); repair from 3/4 of the base
   cells; 64 sample round trips and a tampered proof; a mis-coded entry
   from testing/malicious whose fraud proof is accepted against its
   commitments and refused against the honest ones, and whose repair
   attributes it; the block cache (a hit makes no launch); and
   rs_tunable's axis encode (64 shares to 128) against its host version;
   one `codec_plane` line;
9. times with CUDA events after warm-up: the block, each kernel at the main
   path's shapes, each plain version, K2's library yardsticks (fp16
   torch.matmul and torch._int_mm of the same product) and the two-launch
   extension; the tensor-core instructions in K2's SASS (cuobjdump); and a
   torch.profiler trace of the block for its device busy time by kernel.

The line before the last is {"kernels": [...]}, with each kernel's launches
summed over the paths driven in phases 4 to 8 and split by path; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits with code 2 before any of this.
"""

from __future__ import annotations

import base64
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
from celestia_app_tpu_torch.chain import admission, crypto
from celestia_app_tpu_torch.chain import tx as tx_mod
from celestia_app_tpu_torch.da import (
    blob,
    cmt,
    codec,
    commitment,
    commitment_device,
    dah,
    edscache,
    eds,
    fraud,
    namespace,
    namespace_data,
    namespace_device,
    pcmt,
    proof,
    proof_device,
    repair,
    sampling,
    square,
)
from celestia_app_tpu_torch.ops import (
    ldpc,
    leopard,
    leopard_decode,
    nmt,
    polar,
    rs,
    rs_kernel,
    rs_tunable,
    secp256k1,
    sha256,
    sha256_kernel,
)
from celestia_app_tpu_torch.testing import malicious
from celestia_app_tpu_torch.utils import fast_host, nmt_host
from celestia_app_tpu_torch.wire import codec as wire_codec
from celestia_app_tpu_torch.wire import txpb

SEED = 0
K_MAIN = 128
K1_CHECK_LENGTHS = (542, 181, 91, 65)  # NMT leaf, NMT inner, Merkle leaf, Merkle inner
K1_CHECK_COUNTS = (65536, 1000)  # the leaf level at k = 128, and a ragged N
K2_CHECK_KS = (1, 2, 4, 8, 16, 32, 64, 128)
K2_PATTERNS = ("random", "ones", "zeros")  # all-0xFF puts every s32 sum at its largest
HOST_PROOF_SAMPLE = 16  # share ranges checked against the hashlib proofs
ABSENT_NAMESPACES = 8
K_CROSSWORD = 32
LIGHT_CLIENTS = 64
SAMPLES_PER_CLIENT = 16  # the light node's default
ADMISSION_ACCOUNTS = 64
SENDS_PER_ACCOUNT = 16
ADVERSARIAL_PER_CLASS = 3
HONEST_PY_SAMPLE = 64
RS_TUNABLE_KN = (64, 128)  # an axis of 64 shares stretched to 128 (the matrices are host Lagrange, O(k^3))
ADMISSION_SWEEP_LANES = (256, 1024, 4096, 8192)  # lanes per dispatch, for the cap
# int64 multiply-adds per verified lane, counted off ops/secp256k1: a
# fe_mul is 100 convolution products + 21 fold products + 4 in its two
# carry passes (125); a 21-scaling is 10 + 2. Per lane: 107 complete adds
# (7 for the Q table, 66 in the chain, 34 on the G side) of 12 fe_mul + 2
# scalings, 139 doublings (7 + 132) of 8 fe_mul + 1 scaling, 16 fe_mul for
# the λQ table and 2 for the final check.
SECP_MULADDS_PER_LANE = (107 * 12 + 139 * 8 + 16 + 2) * 125 + (107 * 2 + 139) * 12

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
# the codec roots tests/test_codec_iface.py pins: k = 4 and 8 squares of
# np.random.RandomState(7) bytes, and the empty block
FROZEN_CMT_ROOT = {4: "ecb93696cccd83f43aa92b324296a17fce6c5b3b24c136f50b1e3ed57e3b36da",
                   8: "e8bb3e85b5bfae79438fd436acd1afa22d002a679395c861bb9fba59dfb893ea"}
FROZEN_PCMT_ROOT = {4: "30cd7537522eb44d4daf235a253a29f8336f694626039a4e85b505605fb15986",
                    8: "fe7c3a6cd47a6cb58244971c39e663f46456c8e8e5fb0b47e00c9f1a5a9154cd"}
FROZEN_MIN_ROOT = {"cmt-ldpc": "b14c97a1825a294c0cd9727539c36e8a7b14976b2dd29e7895b79075f1425da7",
                   "pcmt-polar": "ea8f58f171338ec6e9acb8d41651279bdae26755a3e24835d5415a70f4af04e1"}


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
        # the decode operands of one random erasure pattern (k of 2k present)
        pattern = tuple(sorted(rng.choice(2 * k, size=k, replace=False).tolist()))
        run = rs.repair_axes_fn(k, pattern, dev)
        fused = leopard_decode.fused_decode_matrix(k, pattern)
        require(np.array_equal(fused, leopard.matmul(leopard.generator_matrix(k), leopard.decode_matrix(k, pattern))),
                f"the fused decode matrix differs from the generator times the inverse at k={k}")
        bits = leopard.to_bit_matrix(fused)
        require(torch.equal(run.top[: 8 * k, : 8 * k].cpu(), torch.from_numpy(bits[: 8 * k]).to(torch.uint8))
                and torch.equal(run.bottom[: 8 * k, : 8 * k].cpu(), torch.from_numpy(bits[8 * k:]).to(torch.uint8)),
                f"K2 decode operands differ from the fused decode matrix at k={k}")
        src = square_of("random", k, rng, dev)
        for name, operand in (("decode_top", run.top), ("decode_bottom", run.bottom)):
            got = torch.empty_like(src)
            rs_kernel.extend_lines(((src, got),), operand)
            want = rs_kernel.extend_pass_ref(src, operand)
            torch.cuda.synchronize()
            errs[name] = max_abs_err(got, want, 0xFF)
            require(errs[name] == 0, f"K2 with the {name} operand differs from its plain version at k={k}")
        # the repair's own calls, at its shapes: a (2k, 2k, 512) batch of
        # rows and of columns (a strided view), the use shards gathered, the
        # destinations the two strided halves of a fresh output; and the FWHT
        # decode of a pattern with more than k present, against its plain
        # version and against the host decoder on two axes
        wide = (k + k // 2) if k > 1 else 1
        more = tuple(sorted(rng.choice(2 * k, size=wide, replace=False).tolist()))
        batch = torch.from_numpy(rng.integers(0, 256, (2 * k, 2 * k, appconsts.SHARE_SIZE), dtype=np.uint8)).to(dev)
        for name, lines in (("repair_rows", batch), ("repair_cols", batch.transpose(0, 1))):
            got = run(lines)
            torch.cuda.synchronize()
            errs[name] = max_abs_err(got, repair_axes_plain(run, lines), 0xFF)
            require(errs[name] == 0, f"K2 in the {name} decode differs from its plain version at k={k}")
        fwht = rs.repair_axes_fn(k, more, dev)
        got = fwht.decode_fwht(batch)
        torch.cuda.synchronize()
        errs["decode_fwht"] = max_abs_err(got, decode_fwht_plain(fwht, batch), 0xFF)
        require(errs["decode_fwht"] == 0, f"K2 in the FWHT decode differs from its plain version at k={k}")
        missing = list(fwht.missing)
        for i in (0, 2 * k - 1):
            host = rs.repair_axis(batch[i].cpu().numpy(), list(more))[missing]
            require(np.array_equal(got[i].cpu().numpy(), host), f"the FWHT decode differs from the host decoder at k={k}")
        worst = max(worst, *errs.values())
        emit("k2_check", k=k, max_abs_err=max(errs.values()), checks=len(errs), decode_pattern_present=len(pattern),
             fwht_pattern_present=len(more))
    return worst


def repair_axes_plain(run: rs.RepairAxes, lines: torch.Tensor) -> torch.Tensor:
    """RepairAxes' decode through K2's plain version on the same gathered source."""
    src = lines.index_select(1, run.use_index)
    return torch.cat([rs_kernel.extend_pass_ref(src, run.top), rs_kernel.extend_pass_ref(src, run.bottom)], dim=1)


def decode_fwht_plain(run: rs.RepairAxes, lines: torch.Tensor) -> torch.Tensor:
    """RepairAxes.decode_fwht through K2's plain version on the same gathered sources."""
    over_use, over_rest, rest_index = run._fwht_operands()
    m = len(run.missing)
    out = rs_kernel.extend_pass_ref(lines.index_select(1, run.use_index), over_use)[:, :m]
    if m < run.k:
        out = out ^ rs_kernel.extend_pass_ref(lines.index_select(1, rest_index), over_rest)[:, :m]
    return out


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
    main["commitments"] = got
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


def blind_host_root(squares: np.ndarray, axis: str, index: int) -> bytes:
    """One axis root of a possibly corrupt square from the host tree that a
    producer of a bad encoding commits (blind leaf appends)."""
    return nmt_host.serialize(fraud._axis_tree(dah.ExtendedDataSquare(squares), axis, index).root())


def crossword_mask(k: int, seed: int) -> np.ndarray:
    """The first seeded random mask of density 1/2 from `seed` on that the
    crossword solves and that needs more than one sweep: some row starts
    below k shares, so its root is verified only after a column phase has
    completed it. Solvability is the fixpoint on the mask alone."""
    for s in range(seed, seed + 100):
        present = np.random.default_rng(s).random((2 * k, 2 * k)) < 0.5
        if (present.sum(axis=1) >= k).all():
            continue
        known = present.copy()
        while True:
            before = int(known.sum())
            known[known.sum(axis=1) >= k] = True
            known[:, known.sum(axis=0) >= k] = True
            if int(known.sum()) == before:
                break
        if known.all():
            return present
    raise RuntimeError("no solvable crossword mask in 100 seeds")


def sweep_launches(present: np.ndarray) -> dict:
    """The launches of the batched repair of an honest square under
    `present`, from the mask alone: per sweep and orientation, 2 K2 for
    each distinct erasure pattern of the repairable axes, 2 more when some
    axis is fully present (its codeword check), and one K1 reduction of
    1 + log2(2k) launches when any axis completes."""
    two_k = present.shape[0]
    k = two_k // 2
    known = present.copy()
    verified = {"row": np.zeros(two_k, dtype=bool), "col": np.zeros(two_k, dtype=bool)}
    k1 = k2 = 0
    while not (verified["row"].all() and verified["col"].all()):
        progress = False
        for axis in ("row", "col"):
            lines = known if axis == "row" else known.T  # a view: writes reach `known`
            done, full, patterns = [], False, set()
            for i in np.flatnonzero(~verified[axis]):
                n = int(lines[i].sum())
                if n == two_k:
                    full = True
                elif n >= k:
                    patterns.add(tuple(np.flatnonzero(lines[i]).tolist()))
                else:
                    continue
                done.append(i)
            k2 += 2 * len(patterns) + 2 * full
            if done:
                k1 += 1 + int(math.log2(two_k))
                verified[axis][done] = True
                lines[done] = True
                progress = True
        require(progress, "sweep_launches: the mask is not solvable")
    return {"sha256_compress": k1, "rs_extend_lines": k2}


def repair_plane(dev: torch.device, main: dict) -> dict:
    """Repair, bad-encoding fraud proofs and sampling on the main path's
    block, through the rs2d-nmt codec. Returns the launch counts of each
    counted run."""
    ods = main["ods"]
    k = ods.shape[0]
    two_k = 2 * k
    log2_2k = int(math.log2(two_k))
    rs2d = codec.get(codec.RS2D_NAME)
    entry = rs2d.compute_entry(ods)
    honest, d = entry.eds.squares, entry.dah
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counted, times = {}, {}

    # 1. half the columns withheld: every row shares one erasure pattern
    rng = np.random.default_rng(SEED + 4)
    withheld = np.sort(rng.choice(two_k, size=k, replace=False))
    present = np.ones((two_k, two_k), dtype=bool)
    present[:, withheld] = False
    damaged = np.where(present[..., None], honest, 0).astype(np.uint8)
    kept = np.flatnonzero(present[0])
    samples = {(r, int(c)): honest[r, c].tobytes() for r in range(two_k) for c in kept}
    want = {"sha256_compress": 2 * (1 + log2_2k), "rs_extend_lines": 4}
    require(sweep_launches(present) == want, f"sweep_launches of the column withholding != {want}")
    rs.repair_axes_cache_clear()
    leopard_decode.fused_decode_matrix.cache_clear()
    leopard.decode_matrix.cache_clear()
    reset_counts()
    got_ods, times["codec_repair_cold"] = timed(lambda: rs2d.repair(d, samples))
    counted["codec_repair"] = read_counts()
    require(np.array_equal(got_ods, ods), "Rs2dNmtCodec.repair did not give back the ODS")
    reset_counts()
    got_eds, times["repair_eds"] = timed(lambda: repair.repair_eds(damaged, present, list(d.row_roots),
                                                                     list(d.col_roots)))
    counted["repair_columns"] = read_counts()
    for name in ("codec_repair", "repair_columns"):
        require(counted[name] == want, f"{name} launches {counted[name]} != {want}")
    require(np.array_equal(got_eds, honest), "repair_eds on the card differs from the honest EDS")
    cpu_eds, times["repair_eds_cpu"] = timed(lambda: repair.repair_eds(
        damaged, present, list(d.row_roots), list(d.col_roots), device="cpu"))
    require(np.array_equal(cpu_eds, got_eds), "repair_eds on the card differs from the CPU path")
    scalar_eds, times["repair_scalar"] = timed(lambda: repair.repair_eds(
        damaged, present, list(d.row_roots), list(d.col_roots), engine="scalar"))
    require(np.array_equal(scalar_eds, honest), "the scalar engine differs from the honest EDS")
    fresh = tuple(sorted(rng.choice(two_k, size=k, replace=False).tolist()))
    _, times["fused_decode_matrix"] = timed(lambda: leopard_decode.fused_decode_matrix(k, fresh))
    repair_ms = times["repair_eds"] * 1e3

    # 2. a crossword mask at k = 32 that needs more than one sweep
    kc = min(K_CROSSWORD, k)
    ods_c = np.random.default_rng(SEED + 5).integers(0, 256, (kc, kc, appconsts.SHARE_SIZE), dtype=np.uint8)
    ods_c[..., :appconsts.NAMESPACE_SIZE] = 0
    entry_c = rs2d.compute_entry(ods_c)
    mask = crossword_mask(kc, SEED + 6)
    damaged_c = np.where(mask[..., None], entry_c.eds.squares, 0).astype(np.uint8)
    roots_c = (list(entry_c.dah.row_roots), list(entry_c.dah.col_roots))
    scalar_axes = repair.counters["axes_scalar"]
    reset_counts()
    got_c, times["crossword"] = timed(lambda: repair.repair_eds(damaged_c, mask, *roots_c))
    counted["crossword"] = read_counts()
    require(repair.counters["axes_scalar"] == scalar_axes, "the batched crossword decoded an axis on the host")
    want_c = repair.repair_eds(damaged_c, mask, *roots_c, engine="scalar")
    require(np.array_equal(got_c, want_c) and np.array_equal(got_c, entry_c.eds.squares),
            "the k = 32 crossword differs from the scalar engine")
    require(counted["crossword"] == sweep_launches(mask),
            f"crossword launches {counted['crossword']} != {sweep_launches(mask)}")

    # 3. a flipped parity cell, committed under a blind DAH
    bad_row, bad_col = int(rng.integers(0, two_k)), int(rng.integers(k + 1, two_k))
    corrupt = honest.copy()
    corrupt[bad_row, bad_col] ^= 0x5A
    reset_counts()
    (rows_bad, cols_bad), times["blind_dah"] = timed(lambda: (
        nmt.eds_axis_roots(corrupt, list(range(two_k)), k),
        nmt.eds_axis_roots(np.swapaxes(corrupt, 0, 1), list(range(two_k)), k)))
    counted["blind_dah"] = read_counts()
    require(counted["blind_dah"] == {"sha256_compress": 2 * (1 + log2_2k), "rs_extend_lines": 0},
            f"blind DAH launches {counted['blind_dah']}")
    d_bad = dah.DataAvailabilityHeader(row_roots=tuple(r.tobytes() for r in rows_bad),
                                       col_roots=tuple(c.tobytes() for c in cols_bad))
    for axis, i in (("row", bad_row), ("col", bad_col), ("row", 0), ("col", 0)):
        roots = d_bad.row_roots if axis == "row" else d_bad.col_roots
        require(roots[i] == blind_host_root(corrupt, axis, i), f"blind {axis} root {i} differs from the host tree")
    require([r for i, r in enumerate(d_bad.row_roots) if i != bad_row]
            == [r for i, r in enumerate(d.row_roots) if i != bad_row], "blind DAH differs off the corrupt row")
    bad_present = np.ones((two_k, two_k), dtype=bool)
    bad_present[bad_row, bad_col] = False
    reset_counts()
    t0 = time.perf_counter()
    try:
        repair.repair_eds(np.where(bad_present[..., None], corrupt, 0).astype(np.uint8), bad_present,
                          list(d_bad.row_roots), list(d_bad.col_roots))
        raise RuntimeError("chip_smoke check failed: the corrupt square repaired without an error")
    except repair.BadEncodingError as e:
        require((e.axis, e.index) == ("row", bad_row), f"BadEncodingError at {e.axis} {e.index}, not row {bad_row}")
    torch.cuda.synchronize()
    times["bad_repair"] = time.perf_counter() - t0
    counted["bad_repair"] = read_counts()
    # the corrupt row is a group of one (2 K2), the 2k - 1 full rows take
    # the codeword check (2 K2), one K1 reduction of the row roots fails at it
    require(counted["bad_repair"] == {"sha256_compress": 1 + log2_2k, "rs_extend_lines": 4},
            f"bad-encoding repair launches {counted['bad_repair']}")
    # the corrupt cell present and outside the use set (column 0 of its row
    # withheld, so the use set is columns 1..k): the re-encode disagrees at
    # it, and the row takes the FWHT decode through K2 (2 more launches)
    odd_present = np.ones((two_k, two_k), dtype=bool)
    odd_present[bad_row, 0] = False
    odd_damaged = np.where(odd_present[..., None], corrupt, 0).astype(np.uint8)
    inconsistent = repair.counters["inconsistent_axes"]
    reset_counts()
    t0 = time.perf_counter()
    try:
        repair.repair_eds(odd_damaged, odd_present, list(d_bad.row_roots), list(d_bad.col_roots))
        raise RuntimeError("chip_smoke check failed: the inconsistent row repaired without an error")
    except repair.BadEncodingError as e:
        require((e.axis, e.index) == ("row", bad_row), f"BadEncodingError at {e.axis} {e.index}, not row {bad_row}")
    torch.cuda.synchronize()
    times["bad_repair_inconsistent"] = time.perf_counter() - t0
    counted["bad_repair_inconsistent"] = read_counts()
    require(counted["bad_repair_inconsistent"] == {"sha256_compress": 1 + log2_2k, "rs_extend_lines": 6},
            f"inconsistent-row repair launches {counted['bad_repair_inconsistent']}")
    require(repair.counters["inconsistent_axes"] == inconsistent + 1, "the corrupt row was not found inconsistent")
    try:
        repair.repair_eds(odd_damaged, odd_present, list(d_bad.row_roots), list(d_bad.col_roots), engine="scalar")
        raise RuntimeError("chip_smoke check failed: the scalar engine repaired the inconsistent row")
    except repair.BadEncodingError as e:
        require((e.axis, e.index) == ("row", bad_row), "the scalar engine attributes the inconsistent row elsewhere")
    befp, times["generate_befp"] = timed(lambda: fraud.generate_befp(dah.ExtendedDataSquare(corrupt),
                                                                       "row", bad_row))
    reset_counts()
    accepted, times["verify_befp"] = timed(lambda: fraud.verify_befp(d_bad, befp))
    counted["verify_befp"] = read_counts()
    require(accepted is True, "verify_befp refused the proof of the bad row")
    require(counted["verify_befp"] == {"sha256_compress": 1 + log2_2k, "rs_extend_lines": 2},
            f"verify_befp launches {counted['verify_befp']}")
    honest_befp = fraud.generate_befp(entry.eds, "row", bad_row)
    reset_counts()
    refused = fraud.verify_befp(d, honest_befp)
    counted["verify_befp_honest"] = read_counts()
    require(refused is False, "verify_befp accepted a proof against the honest block")

    # 4. light clients sampling the honest block
    reset_counts()
    prover, times["sampling_prover"] = timed(entry.get_prover)
    counted["sampling_prover"] = read_counts()
    fetch_errors = sampling.sample_block.fetch_errors
    t0 = time.perf_counter()
    reports = [sampling.sample_block(d, prover.prove_cell, SAMPLES_PER_CLIENT, np.random.default_rng(SEED * 1000 + i))
               for i in range(LIGHT_CLIENTS)]
    times["sampling"] = time.perf_counter() - t0
    require(all(r.available and r.verified == SAMPLES_PER_CLIENT for r in reports), "a light client's sample failed")
    require(sampling.sample_block.fetch_errors == fetch_errors, "a sample fetch raised")
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    # 5. the card's busy share of the warm repair
    run_repair = lambda: repair.repair_eds(damaged, present, list(d.row_roots), list(d.col_roots))  # noqa: E731
    device_profile("repair_profile", run_repair, repair_ms)
    emit("repair_plane", k=k, withheld_columns=int(withheld.size), launches=counted,
         crossword_k=kc, crossword_present=int(mask.sum()),
         crossword_rows_below_k=int((mask.sum(axis=1) < kc).sum()),
         bad_cell=[bad_row, bad_col], befp_accepted=accepted, honest_befp_refused=not refused,
         light_clients=len(reports), samples_verified=sum(r.verified for r in reports),
         confidence=reports[0].confidence, repair_counters=dict(repair.counters),
         times_ms={name: v * 1e3 for name, v in times.items()}, peak_mib=peak_mib)
    return counted


class StubAuth:
    """The account keeper as admission reads it: address -> number."""

    def __init__(self, numbers: dict[bytes, int]):
        self.numbers = numbers

    def account(self, ctx, addr: bytes):
        number = self.numbers.get(addr)
        return None if number is None else {"number": number}


class AdmissionApp:
    """The duck-typed App of chain/admission: its caches, chain identity and
    accounts. The store is never read: StubAuth answers from its table."""

    def __init__(self, chain_id: str, numbers: dict[bytes, int]):
        self.sig_cache = admission.VerifiedSigCache()
        self.commitment_cache = admission.VerifiedCommitmentCache()
        self.app_version = 3
        self.engine = "device"
        self.chain_id = chain_id
        self.height = 1
        self.store = None
        self._check_state = None
        self.auth = StubAuth(numbers)


def send_body(chain_id: str, sender: bytes, to: bytes, number: int, sequence: int) -> tx_mod.TxBody:
    return tx_mod.TxBody(msgs=(tx_mod.MsgSend(sender, to, 1000),), chain_id=chain_id, account_number=number,
                         sequence=sequence, fee=2000, gas_limit=100_000)


def flip_bit(raw: bytes, from_end: int, bit: int) -> bytes:
    out = bytearray(raw)
    out[-from_end] ^= 1 << bit
    return bytes(out)


def off_curve_pubkey(start: int) -> bytes:
    """A compressed encoding whose x (from `start` up) is not on the curve."""
    x = start
    while crypto._decompress(b"\x02" + x.to_bytes(32, "big")) is not None:
        x += 1
    return b"\x02" + x.to_bytes(32, "big")


def proto_tx_with(body: tx_mod.TxBody, priv: crypto.PrivateKey, pubkey: bytes, signature=None) -> bytes:
    """A TxRaw carrying `pubkey` in its signer info, signed by `priv` over
    the sign doc of `body` (or carrying `signature` as given)."""
    body_bytes = txpb.tx_body_pb(body.msgs, body.memo, body.timeout_height)
    auth_bytes = txpb.auth_info_pb(pubkey, body.sequence, body.fee, body.gas_limit)
    if signature is None:
        signature = priv.sign(txpb.sign_doc_pb(body_bytes, auth_bytes, body.chain_id, body.account_number))
    return txpb.tx_raw_pb(body_bytes, auth_bytes, signature)


def admission_traffic(sq: square.Square, commitments: list[bytes]) -> dict:
    """The proposer's batch at the v3 square cap: 1,024 MsgSends from 64
    seeded accounts, the block's PFBs as signed BlobTxs, and seeded
    adversarial raws, each lane's verdict known by construction. Returns
    the raws in order, the app, the (pubkey, sig, doc) items of the lanes
    that must reach the card with their verdicts, and the classes' counts."""
    chain_id = "chip-smoke"
    rng = np.random.default_rng(SEED + 7)
    privs = [crypto.PrivateKey.from_seed(b"chip-smoke-account-%d" % i) for i in range(ADMISSION_ACCOUNTS)]
    addrs = [p.public_key().address() for p in privs]
    numbers = {a: i for i, a in enumerate(addrs)}
    raws, lanes, classes = [], [], {}

    def add(name: str, raw: bytes, item=None, verdict=None) -> None:
        raws.append(raw)
        classes[name] = classes.get(name, 0) + 1
        if item is not None:
            lanes.append((item, verdict, name))

    def signed(body, priv, name: str, number: int) -> None:
        ptx = wire_codec.sign_tx_proto(body, priv)
        add(name, ptx.encode(), (ptx.pubkey, ptx.signature, ptx.sign_doc(chain_id, number)), True)

    for seq in range(SENDS_PER_ACCOUNT):
        for i, priv in enumerate(privs):
            signed(send_body(chain_id, addrs[i], addrs[(i + 1) % len(addrs)], i, seq), priv, "send", i)
    blobs = [b for e in sq.pfbs for b in e.blobs]
    require(len(commitments) == len(blobs), "one commitment per blob")
    at = 0
    for j, entry in enumerate(sq.pfbs):
        i = j % len(privs)
        n = len(entry.blobs)
        msg = tx_mod.MsgPayForBlobs(
            signer=addrs[i], namespaces=tuple(b.namespace.raw for b in entry.blobs),
            blob_sizes=tuple(len(b.data) for b in entry.blobs), share_commitments=tuple(commitments[at:at + n]),
            share_versions=tuple(b.share_version for b in entry.blobs))
        at += n
        body = tx_mod.TxBody(msgs=(msg,), chain_id=chain_id, account_number=i,
                             sequence=SENDS_PER_ACCOUNT + j // len(privs), fee=200_000, gas_limit=10_000_000)
        ptx = wire_codec.sign_tx_proto(body, privs[i])
        add("pfb", blob.marshal_blob_tx(ptx.encode(), list(entry.blobs)),
            (ptx.pubkey, ptx.signature, ptx.sign_doc(chain_id, i)), True)
    honest_raws = list(raws)
    for c in range(ADVERSARIAL_PER_CLASS):
        i = int(rng.integers(0, len(privs)))
        priv, seq = privs[i], 100 + c
        body = send_body(chain_id, addrs[i], addrs[(i + 1) % len(addrs)], i, seq)
        # legacy framing: the sign doc carries the account number itself
        ltx = tx_mod.sign_tx(body, priv)
        add("legacy", ltx.encode(), (ltx.pubkey, ltx.signature, ltx.sign_doc()), True)
        # a flipped bit in r (the signature is the TxRaw's last 64 bytes)
        ptx = wire_codec.sign_tx_proto(body, priv)
        bad = flip_bit(ptx.encode(), 64 - int(rng.integers(1, 31)), int(rng.integers(0, 8)))
        dec = wire_codec.decode_proto_tx(bad)
        add("flipped_bit", bad, (dec.pubkey, dec.signature, dec.sign_doc(chain_id, i)), False)
        # signed under the wrong account number
        wrong = dataclasses.replace(body, account_number=i + 1000, sequence=seq + 10)
        ptx = wire_codec.sign_tx_proto(wrong, priv)
        add("wrong_account_number", ptx.encode(), (ptx.pubkey, ptx.signature, ptx.sign_doc(chain_id, i)), False)
        # a pubkey off the curve, registered as an account so the lane reaches the card
        pub = off_curve_pubkey(int(rng.integers(1, 1 << 60)))
        numbers[crypto.PublicKey(pub).address()] = ADMISSION_ACCOUNTS + c
        raw = proto_tx_with(body, priv, pub)
        dec = wire_codec.decode_proto_tx(raw)
        add("off_curve_pubkey", raw, (pub, dec.signature, dec.sign_doc(chain_id, ADMISSION_ACCOUNTS + c)), False)
        # r = 0 and r = n reach the card; s >= n, high-S and a 63-byte
        # signature are dropped by extract_sig_item (policy)
        good = wire_codec.sign_tx_proto(body, priv)
        doc = good.sign_doc(chain_id, i)
        s = int.from_bytes(good.signature[32:], "big")
        for name, sig in (("r_zero", b"\x00" * 32 + good.signature[32:]),
                          ("r_is_n", crypto._N.to_bytes(32, "big") + good.signature[32:])):
            add(name, proto_tx_with(body, priv, good.pubkey, sig), (good.pubkey, sig, doc), False)
        for name, sig in (("s_ge_n", good.signature[:32] + (crypto._N + c).to_bytes(32, "big")),
                          ("high_s", good.signature[:32] + (crypto._N - s).to_bytes(32, "big")),
                          ("short_sig", good.signature[:63])):
            add(name, proto_tx_with(body, priv, good.pubkey, sig))
        add("undecodable", b"BLOB" + rng.bytes(8) + b"\xff")
        add("junk", rng.bytes(int(rng.integers(20, 200))))
        stranger = crypto.PrivateKey.from_seed(b"chip-smoke-stranger-%d" % c)
        add("unknown_account", wire_codec.sign_tx_proto(
            send_body(chain_id, stranger.public_key().address(), addrs[0], 0, 0), stranger).encode())
        add("duplicate", honest_raws[int(rng.integers(0, len(honest_raws)))])
    app = AdmissionApp(chain_id, numbers)
    return {"raws": raws, "app": app, "lanes": lanes, "classes": classes, "blobs": blobs}


def secp256k1_bound_ms(lanes: int) -> tuple[float, str]:
    """The least time of a dispatch of `lanes` on the card, from the int64
    multiply-adds the verifier does per lane. Hopper has no 64-bit integer
    multiplier: int64 products are emulated with 32-bit IMADs (three for a
    full 64 x 64 -> 64 product). The limbs here are < 2^30, so one
    IMAD.WIDE (32 x 32 + 64 -> 64) per multiply-add is the least a kernel
    needs: the bound counts one 32-bit integer operation per multiply-add.
    The bytes (limbs, digits and the 4.2 MB G table) are far below it."""
    ops_s = lanes * SECP_MULADDS_PER_LANE / INT32_OPS_PER_S
    bytes_s = (lanes * (4 * 10 + 102) * 8 + 2 * 17 * 512 * 30 * 8) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def admission_plane(dev: torch.device, main: dict) -> dict:
    """Batched signature admission and the commitment half on the main
    path's block: chain/admission.prevalidate over the proposer's batch at
    the v3 square cap, on the card. Returns the launch counts of the
    counted run."""
    sq = main["square"]
    t0 = time.perf_counter()
    traffic = admission_traffic(sq, commitment.create_commitments(
        [b for e in sq.pfbs for b in e.blobs], appconsts.SUBTREE_ROOT_THRESHOLD))
    sign_s = time.perf_counter() - t0
    raws, app, lanes, blobs = traffic["raws"], traffic["app"], traffic["lanes"], traffic["blobs"]
    honest = [item for item, verdict, _ in lanes if verdict]
    adversarial = [item for item, verdict, _ in lanes if not verdict]
    threshold = appconsts.SUBTREE_ROOT_THRESHOLD
    _, groups = commitment_device.plan(blobs, threshold)
    want_k1 = sum(1 + int(math.log2(s)) for s in groups)
    times = {"sign_traffic": sign_s}

    # the G table: built on the host once, uploaded once per device
    _, times["g_table_build"] = timed(secp256k1._g_pos_tables)
    _, times["g_table_upload"] = timed(lambda: secp256k1.g_table(dev))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_adm = dict(admission.counters)
    before_fast = dict(secp256k1.counters)
    reset_counts()
    verified, times["prevalidate"] = timed(lambda: admission.prevalidate(app, raws))
    counted = read_counts()
    delta = {k: admission.counters[k] - before_adm[k] for k in admission.counters}
    fast_delta = {k: secp256k1.counters[k] - before_fast[k] for k in secp256k1.counters}
    n_lanes = len(lanes)
    dispatches = -(-n_lanes // secp256k1.MAX_DISPATCH)
    require(verified == len(honest), f"prevalidate verified {verified} lanes, not the {len(honest)} honest")
    want_keys = {admission.sig_key(*item) for item in honest}
    require(len(app.sig_cache) == len(want_keys) and set(app.sig_cache.keys()) == want_keys,
            "the sig cache differs from the honest lanes' keys")
    require(delta["admission.batch_lanes"] == n_lanes, f"{delta['admission.batch_lanes']} lanes, not {n_lanes}")
    require(delta["admission.batch_rejected"] == len(adversarial),
            f"batch_rejected {delta['admission.batch_rejected']} != {len(adversarial)} adversarial lanes")
    for name in ("admission.prevalidate_errors", "admission.prevalidate_below_batch",
                 "commitment.prevalidate_below_batch"):
        require(delta[name] == 0, f"{name} = {delta[name]}")
    require(fast_delta["secp256k1.slow_lanes"] == 0, "a lane took the scalar path")
    require(delta["admission.batch_dispatches"] == dispatches == fast_delta["secp256k1.dispatches"],
            f"dispatches {delta['admission.batch_dispatches']} / {fast_delta['secp256k1.dispatches']} != {dispatches}")
    require(counted == {"sha256_compress": want_k1, "rs_extend_lines": 0},
            f"admission launches {counted} != {want_k1} K1 from the plan")
    require(delta["commitment.batch_lanes"] == len(blobs), f"{delta['commitment.batch_lanes']} blobs computed")
    cached = [app.commitment_cache.hit(admission.commitment_key(b.namespace.raw, b.share_version, b.data, threshold))
              for b in blobs]
    host = commitment.create_commitments(blobs, threshold)
    require(cached == host == main["commitments"],
            "cached commitments differ from hashlib or from the proof plane's")

    # the mask on the card against the CPU path and _py_verify
    items = [item for item, _, _ in lanes]
    want = [verdict for _, verdict, _ in lanes]
    mask, times["verify_batch_host_clock"] = timed(lambda: secp256k1.verify_batch(items))
    require(list(mask) == want, "the card's mask differs from the verdicts by construction")
    cpu_mask, times["verify_batch_cpu"] = timed(lambda: secp256k1.verify_batch(items, device="cpu"))
    require(np.array_equal(mask, cpu_mask), "the card's mask differs from the CPU path's")
    rng = np.random.default_rng(SEED + 8)
    sample = [honest[int(i)] for i in rng.choice(len(honest), HONEST_PY_SAMPLE, replace=False)]
    t0 = time.perf_counter()
    py = [crypto._py_verify(*item) for item in sample]
    times["py_verify_per_lane"] = (time.perf_counter() - t0) / len(sample)
    require(py == [True] * len(sample) and [crypto._py_verify(*item) for item in adversarial] == [False] * len(adversarial),
            "_py_verify differs from the card's mask")
    require(list(secp256k1.verify_batch(adversarial)) == [False] * len(adversarial)
            and list(secp256k1.verify_batch(sample)) == [True] * len(sample),
            "the card's mask on the adversarial lanes or the sample differs from _py_verify")

    # a second prevalidate of the same raws computes nothing: every honest
    # lane and blob is cached; failures are never cached, so the
    # adversarial lanes come back, and below the gate they are not sent
    before_adm = dict(admission.counters)
    before_fast = dict(secp256k1.counters)
    reset_counts()
    again = admission.prevalidate(app, raws)
    repeat = {"verified": again, "launches": read_counts(),
              "batch_dispatches": admission.counters["admission.batch_dispatches"] - before_adm["admission.batch_dispatches"],
              "dispatches": secp256k1.counters["secp256k1.dispatches"] - before_fast["secp256k1.dispatches"]}
    resent = 0 if len(adversarial) < admission.MIN_DEVICE_BATCH else -(-len(adversarial) // secp256k1.MAX_DISPATCH)
    require(repeat == {"verified": 0, "launches": {"sha256_compress": 0, "rs_extend_lines": 0},
                       "batch_dispatches": resent, "dispatches": resent}, f"the repeat prevalidate did work: {repeat}")
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    # times: _prep of the batch, one dispatch by CUDA events, and the cap
    t0 = time.perf_counter()
    preps = [secp256k1._prep(*item) for item in items]
    times["prep_batch"] = time.perf_counter() - t0
    preps = [p for p in preps if p is not None]
    dispatch_ms = cuda_ms(lambda: secp256k1._dispatch(preps, dev), reps=2, warmup=1)
    sweep = {}
    for n in ADMISSION_SWEEP_LANES:
        batch = (preps * (n // len(preps) + 1))[:n]
        sweep[n] = cuda_ms(lambda: secp256k1._dispatch(batch, dev), reps=1, warmup=1)
    device_profile("admission_profile", lambda: secp256k1._dispatch(preps, dev), dispatch_ms, reps=1)
    bound_ms, bound_by = secp256k1_bound_ms(len(preps))
    emit("admission_plane", raws=len(raws), classes=traffic["classes"], lanes=n_lanes, honest=len(honest),
         adversarial_on_card=len(adversarial), verified=verified, launches=counted, counters=delta,
         secp256k1=fast_delta, max_dispatch=secp256k1.MAX_DISPATCH, commitments=len(blobs),
         repeat=repeat, device_lanes=len(preps),
         verify_dispatch_ms=dispatch_ms, lanes_per_s=len(preps) / dispatch_ms * 1e3,
         dispatch_ms_by_lanes=sweep, lanes_per_s_by_lanes={n: n / ms * 1e3 for n, ms in sweep.items()},
         bound_ms=bound_ms, bound_by=bound_by, muladds_per_lane=SECP_MULADDS_PER_LANE,
         times_ms={name: v * 1e3 for name, v in times.items()}, peak_mib=peak_mib)
    return {"admission": counted}


def cmt_host_layers(ods: np.ndarray) -> tuple[list[np.ndarray], list[np.ndarray], bytes]:
    """The CMT encode on the host: numpy LDGM encode and hashlib. (layers,
    hash lists, data root)."""
    k = ods.shape[0]
    data = cmt.ods_symbols(ods)
    layers, hashes = [], []
    for _ in cmt.layer_plan(k):
        layers.append(np.concatenate([data, ldpc.encode_host(data)]))
        hashes.append(fast_host.sha_many(layers[-1]))
        data = hashes[-1].reshape(-1, cmt.Q * cmt.HASH_BYTES)
    return layers, hashes, cmt.CmtCommitments(k, tuple(bytes(h) for h in hashes[-1])).hash()


def pcmt_host_layers(ods: np.ndarray) -> tuple[list[np.ndarray], list[np.ndarray], bytes]:
    """The PCMT encode on the host: numpy polar encode and hashlib."""
    k = ods.shape[0]
    plan = pcmt.layer_plan(k)
    layers, hashes = [polar.encode_host(cmt.ods_symbols(ods))], []
    for j in range(len(plan)):
        hashes.append(fast_host.sha_many(layers[-1]))
        if j + 1 < len(plan):
            level = np.zeros((plan[j + 1][0] * pcmt.Q, pcmt.HASH_BYTES), dtype=np.uint8)
            level[: len(hashes[-1])] = hashes[-1]
            for _ in range(pcmt.LOG2Q):
                level = fast_host.sha_many(level.reshape(-1, 2 * pcmt.HASH_BYTES))
            layers.append(polar.encode_host(level))
    return layers, hashes, pcmt.PcmtCommitments(k, tuple(bytes(h) for h in hashes[-1])).hash()


def codec_geometry_clear() -> None:
    """Forget every derived code table, host and device, so the next encode
    is cold."""
    for fn in (ldpc.parity_indices, ldpc._device_table, polar.geometry, polar._device_plan):
        fn.cache_clear()


def peel_check(scheme: str, base: np.ndarray, rng: np.random.Generator, k: int) -> dict:
    """The card's peel of the base layer, a seeded quarter erased, and of the
    same input with one present parity symbol flipped, against the host
    peel: bytes, known and sweeps."""
    n = len(base)
    known = np.ones(n, dtype=bool)
    known[rng.choice(n, size=n // 4, replace=False)] = False
    clean = np.where(known[:, None], base, 0).astype(np.uint8)
    flipped = clean.copy()
    flipped[int(np.flatnonzero(known[k * k:])[0]) + k * k, 0] ^= 0xFF
    out = {}
    for name, syms in (("quarter", clean), ("flipped", flipped)):
        if scheme == codec.CMT_NAME:
            card, host = lambda: ldpc.peel(syms, known), lambda: ldpc.peel_host(syms, known)
        else:
            card, host = lambda: polar.peel(k * k, syms, known), lambda: polar.peel_host(k * k, syms, known)
        syncs = ldpc.peel_members.syncs
        got, card_s = timed(card)
        syncs = ldpc.peel_members.syncs - syncs
        want, host_s = timed(host)
        require(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]) and got[2] == want[2],
                f"{scheme} peel on the card differs from the host peel ({name})")
        require(syncs == got[2] + 1, f"{scheme} peel read {syncs} flags for {got[2]} sweeps")
        out[name] = {"sweeps": got[2], "syncs": syncs, "unknown_after": int((~got[1]).sum()),
                     "card_ms": card_s * 1e3, "host_ms": host_s * 1e3}
    require(out["quarter"]["unknown_after"] == 0, f"{scheme} peel left a quarter-erased base incomplete")
    return out


def download_split(n_bytes: int, dev: torch.device, reps: int = 3) -> dict:
    """Mean ms to bring n_bytes from the card into fresh pageable memory
    (what `.cpu()` does), into pageable memory touched before, and into
    pinned memory: the copy's rate apart from first-touch page faults."""
    src = torch.ones(n_bytes, dtype=torch.uint8, device=dev)
    touched = torch.from_numpy(np.ones(n_bytes, dtype=np.uint8))
    pinned = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
    out = {}
    for name, fn in (("fresh_pageable", src.cpu), ("touched_pageable", lambda: touched.copy_(src)),
                     ("pinned", lambda: pinned.copy_(src))):
        out[name] = sum(timed(fn)[1] for _ in range(reps)) / reps * 1e3
    return out


def codec_plane(dev: torch.device, main: dict) -> dict:
    """The cmt-ldpc and pcmt-polar codecs on the main path's k = 128 ODS:
    encode cold and warm against the host yardstick, the frozen roots, the
    ops (encode and peel) against their host versions, repair, sampling,
    fraud proofs and the cache. Returns the launch counts of each counted
    run."""
    ods = main["ods"]
    k = ods.shape[0]
    counted = {}
    report = {}
    keys = {s: edscache.cache_key(ods, s) for s in (codec.RS2D_NAME, codec.CMT_NAME, codec.PCMT_NAME)}
    require(len(set(keys.values())) == 3, "two schemes share a cache key")
    for scheme, host_layers, frozen in ((codec.CMT_NAME, cmt_host_layers, FROZEN_CMT_ROOT),
                                        (codec.PCMT_NAME, pcmt_host_layers, FROZEN_PCMT_ROOT)):
        c = codec.get(scheme)
        plan = (cmt if scheme == codec.CMT_NAME else pcmt).layer_plan(k)
        # one K1 launch per layer hash, and for PCMT one per subtree level
        want_k1 = len(plan) if scheme == codec.CMT_NAME else len(plan) + (len(plan) - 1) * pcmt.LOG2Q
        want = {"sha256_compress": want_k1, "rs_extend_lines": 0}
        times, rng = {}, np.random.default_rng(SEED + 9)

        # 1. encode, cold (every code table derived and uploaded) and warm
        codec_geometry_clear()
        torch.cuda.synchronize()
        reset_counts()
        entry, times["encode_cold"] = timed(lambda: c.compute_entry(ods))
        counted[f"{scheme}_encode_cold"] = read_counts()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        warm, times["encode_warm"] = timed(lambda: c.compute_entry(ods))
        counted[f"{scheme}_encode_warm"] = read_counts()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        for run in ("encode_cold", "encode_warm"):
            require(counted[f"{scheme}_{run}"] == want, f"{scheme} {run} launches {counted[f'{scheme}_{run}']} != {want}")
        encode_ms = cuda_ms(lambda: c.compute_entry(ods), reps=3, warmup=1)
        (layers, hashes, host_root), times["host_yardstick"] = timed(lambda: host_layers(ods))
        require(entry.data_root == warm.data_root == host_root == entry.dah.hash(),
                f"{scheme} data root on the card differs from the host yardstick")
        require(all(np.array_equal(a, b) for a, b in zip(entry.layers + entry.hash_lists, layers + hashes))
                and len(entry.layers) == len(layers) == len(plan), f"{scheme} layers differ from the host yardstick")
        require(np.array_equal(entry.ods(), ods), f"{scheme} entry's ODS differs")
        profile = device_profile(f"{scheme}_encode_profile", lambda: c.compute_entry(ods), times["encode_warm"] * 1e3,
                                 reps=1)
        arrays = entry.layers + entry.hash_lists + [lvl for levels in getattr(entry, "subtrees", []) for lvl in levels]
        download_bytes = sum(a.nbytes for a in arrays)

        # 2. frozen roots at k = 4 and 8 and the empty block, on the card
        reset_counts()
        for small, root in frozen.items():
            got = c.compute_entry(np.random.RandomState(7).randint(0, 256, (small, small, 512), dtype=np.uint8))
            require(got.data_root.hex() == root, f"{scheme} k={small} root {got.data_root.hex()} != frozen {root}")
        require(c.min_entry().data_root.hex() == FROZEN_MIN_ROOT[scheme], f"{scheme} empty-block root differs")
        counted[f"{scheme}_golden"] = read_counts()

        # 3. ops: the card's encode and peel against the host versions
        data = cmt.ods_symbols(ods)
        if scheme == codec.CMT_NAME:
            card_base = ldpc.encode(data).cpu().numpy()
            require(np.array_equal(card_base, ldpc.encode_host(data)), "ldpc.encode on the card differs")
        else:
            card_base = polar.encode(data).cpu().numpy()
            require(np.array_equal(card_base, polar.encode_host(data)), "polar.encode on the card differs")
        peel = peel_check(scheme, entry.layers[0], rng, k)

        # 4. repair from a seeded 3/4 of the base cells, straight from the entry
        comm = c.commitments_from_doc(c.commitments_doc(entry), entry.data_root.hex(), k)
        n_base = comm.n_base
        keep = np.sort(rng.choice(n_base, size=n_base - n_base // 4, replace=False))
        samples = {(0, int(i)): entry.layers[0][i].tobytes() for i in keep}
        reset_counts()
        repaired, times["repair"] = timed(lambda: c.repair(comm, samples))
        counted[f"{scheme}_repair"] = read_counts()
        require(np.array_equal(repaired, ods), f"{scheme} repair did not give back the ODS")
        require(counted[f"{scheme}_repair"] == want, f"{scheme} repair launches {counted[f'{scheme}_repair']}")

        # 5. sampling: seeded round trips and a tampered proof
        t0 = time.perf_counter()
        cells = [(0, int(i)) for i in rng.choice(n_base, size=LIGHT_CLIENTS, replace=False)]
        for cell in cells:
            got = c.verify_sample(comm, c.open_sample(entry, cell))
            require(got is not None and got[0] == cell and got[1] == entry.layers[0][cell[1]].tobytes(),
                    f"{scheme} sample {cell} did not verify")
        times["sampling"] = time.perf_counter() - t0
        doc = c.open_sample(entry, cells[0])

        def flip_b64(text: str) -> str:
            raw = bytearray(base64.b64decode(text))
            raw[0] ^= 1
            return base64.b64encode(bytes(raw)).decode()

        tampered = [{**doc, "symbol": flip_b64(doc["symbol"])}]
        if doc["steps"]:
            tampered.append({**doc, "steps": [[flip_b64(doc["steps"][0][0])] + doc["steps"][0][1:]]
                             + doc["steps"][1:]})
        require(all(c.verify_sample(comm, bad_doc) is None for bad_doc in tampered),
                f"{scheme} accepted a tampered proof")

        # 6. fraud: a mis-coded entry from the malicious producer, on the card
        reset_counts()
        if scheme == codec.CMT_NAME:
            bad, times["malicious_encode"] = timed(lambda: malicious.cmt_bad_parity_entry(ods, 3))
            location = (0, 3)
        else:
            bad, times["malicious_encode"] = timed(lambda: malicious.pcmt_bad_parity_entry(ods))
            location = bad.fraud_location
        counted[f"{scheme}_malicious"] = read_counts()
        require(counted[f"{scheme}_malicious"] == want, f"{scheme} malicious encode launches")
        proof, times["build_fraud_proof"] = timed(lambda: c.build_fraud_proof(bad, location))
        accepted, times["verify_fraud_proof"] = timed(lambda: c.verify_fraud_proof(bad.dah, proof))
        require(accepted is True, f"{scheme} fraud proof refused against the bad commitments")
        require(c.verify_fraud_proof(comm, proof) is False, f"{scheme} fraud proof accepted against honest ones")
        all_bad = {(0, i): bad.layers[0][i].tobytes() for i in range(n_base)}
        reset_counts()
        t0 = time.perf_counter()
        try:
            c.repair(bad.dah, all_bad)
            raise RuntimeError(f"chip_smoke check failed: {scheme} repaired a mis-coded block")
        except codec.BadEncodingDetected as e:
            require(e.location == location, f"{scheme} repair attributes {e.location}, not {location}")
        times["bad_repair"] = time.perf_counter() - t0
        counted[f"{scheme}_bad_repair"] = read_counts()

        # 7. the cache: a miss encodes, the second call is a hit with no launch
        cache = edscache.EdsCache()
        reset_counts()
        cached = cache.get_or_compute(ods, scheme=scheme)
        counted[f"{scheme}_cache_miss"] = read_counts()
        reset_counts()
        again = cache.get_or_compute(ods, scheme=scheme)
        counted[f"{scheme}_cache_hit"] = read_counts()
        require(again is cached and cached.data_root == entry.data_root and cache.hits == 1,
                f"{scheme} cache did not hit")
        require(counted[f"{scheme}_cache_miss"] == want and counted[f"{scheme}_cache_hit"] == {
            "sha256_compress": 0, "rs_extend_lines": 0}, f"{scheme} cache launches")
        report[scheme] = {
            "data_root": entry.data_root.hex(), "plan": plan, "n_base": n_base, "base_mib": entry.layers[0].nbytes / 2**20,
            "k1_per_encode": want_k1, "encode_ms_cuda_events": encode_ms, "peak_mib": peak_mib,
            "copies_per_encode": profile["copies_per_call"], "encode_device_busy_ms": profile["device_busy_ms"],
            "encode_idle_share": profile["idle_share"], "download_mib": download_bytes / 2**20,
            "download_ms": download_split(download_bytes, dev), "peel": peel, "fraud_location": list(location),
            "times_ms": {name: v * 1e3 for name, v in times.items()},
        }
    # the tunable-rate RS trade-study code: one axis encode on the card
    shards = cmt.ods_symbols(ods)[:RS_TUNABLE_KN[0]]
    _, first_s = timed(lambda: rs_tunable.encode_axis(shards, RS_TUNABLE_KN[1]))  # builds the matrices
    (got, card_s), (want, host_s) = (timed(lambda: rs_tunable.encode_axis(shards, RS_TUNABLE_KN[1])),
                                     timed(lambda: rs_tunable.encode_axis_host(shards, RS_TUNABLE_KN[1])))
    require(np.array_equal(got, want), "rs_tunable.encode_axis on the card differs from the host")
    report["rs_tunable"] = {"k_n": RS_TUNABLE_KN, "first_call_ms": first_s * 1e3, "card_ms": card_s * 1e3,
                            "host_ms": host_s * 1e3}
    emit("codec_plane", k=k, launches=counted, schemes=report)
    return counted


def device_profile(phase: str, fn, wall_ms: float, reps: int = 3) -> dict:
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
    copies: dict[str, float] = {}
    ops = h2d = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
            ops += 1
            h2d += "HtoD" in e.name
            if "Memcpy" in e.name:
                copies[e.name] = copies.get(e.name, 0) + 1 / reps
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    summary = {"device_busy_ms": busy_ms, "device_ops_per_call": ops / reps, "h2d_copies_per_call": h2d / reps,
               "copies_per_call": copies, "idle_share": 1 - busy_ms / wall_ms}
    emit(phase, **summary, top_ms=[[name[:72], ms] for name, ms in top])
    return summary


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
    repair_counts = repair_plane(dev, main)
    by_path["repair_plane"] = {name: sum(c[name] for c in repair_counts.values())
                               for name in ("sha256_compress", "rs_extend_lines")}
    by_path["admission_plane"] = admission_plane(dev, main)["admission"]
    codec_counts = codec_plane(dev, main)
    by_path["codec_plane"] = {name: sum(c[name] for c in codec_counts.values())
                              for name in ("sha256_compress", "rs_extend_lines")}
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
