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
8. the node plane (`node_plane`), one validator on the card: a port Node
   (App on cuda, app version 3, the admission plane's 64 accounts and 4
   validators, the v3 cap as the governance square size) admits the
   admission plane's 1,024 MsgSends and the block's 86 PFBs through
   broadcast_txs, then produce_blocks_batched runs until the mempool is
   empty, then one empty height; a follower App with its own cache
   processes, finalizes and commits every height. It requires: every tx
   admitted with no scalar signature verify on the proposer, no prewarm
   error and the plan misses the plan predicts, a k = 128 height, every
   block accepted, equal tx results and app hashes at every height, each
   data root equal to the CPU path on the same square, a copy of the first
   PFB height with one blob byte flipped (its PFB re-signed) rejected for
   `data root mismatch` and counted so, the first batched call and the
   follower's first height under no_implicit_transfers(), and the five
   app-hash pins of tests/test_apphash_pin.py on the card; it prints one
   `node_height` line per height (launches read after the warmer is idle,
   span times, bytes crossed, cache hits) and one `node_plane` line (a
   profiled replay of the first height, blocks per second, peak memory
   above the phase's start);
9. the consensus plane (`consensus_plane`), four port validators on the
   card: ValidatorNodes (app version 3, the node plane's accounts, each
   validator's pubkey in genesis, a data_dir each for the file chain
   store, the WAL and the sign state) in a LocalNetwork. Each admits the
   admission plane's 1,110 honest raws through add_txs (one verify
   dispatch and 21 K1 each, no scalar verify); produce_height runs until
   every mempool is empty, then once more. Every height must be certified
   in round 0 with all four prevotes and precommits non-nil, no
   ProcessProposal reject, no proposer error and no warm error, and each
   validator's K1 / K2 launches (read after every warmer is idle) must be
   those of the new squares its cache missed: one compute_entry and the
   warm's two level passes each (37 K1 and 2 K2 at k = 128); each data
   root equals the CPU path. A fifth App replays the first k = 128 height
   under torch.profiler. Then: 4 sends through broadcast_tx (a scalar
   CheckTx on each validator) and consensus.post_wal_pre_apply armed on
   the validator applied last: it stops after its WAL record, is rebuilt
   with its commits wiped and replays the WAL (a verify dispatch on the
   card) to the network's app hash; its QueryRouter, cache cold, serves
   the k = 128 height (the DAH equal to the live one, a blob's share
   proof, a PFB's tx proof, the parity corner, a present and an absent
   namespace, each verified; tx, status, bank/balance) with one
   compute_entry and the row level pass (28 K1, 2 K2) on the first route
   and no launch after; a conflicting prevote is injected and the next
   height tombstones and jails its signer on all four; a fifth validator
   joins by state sync and a flipped chunk and recomputed manifest
   hashes are refused. One `consensus_height` line per height (launches,
   bytes crossed, cache misses and sign-state fsync time per validator,
   span times of prepare, process, finalize, commit, wal.append and
   apply) and one `consensus_plane` line;
10. the network plane (`network_plane`), validators over sockets on the
   card: four port ValidatorServices (the consensus plane's genesis, a
   data_dir each) with a ConsensusReactor each (the reference's
   ReactorConfig but snapshot_interval 2) gossip over 127.0.0.1; a gate
   holds each reactor's loop between steps so the phase says when a
   height runs. Four empty heights; one validator goes down; the 1,110
   honest raws are POSTed to the next proposer's /broadcast_tx and the
   CAT gossip (SeenTx, WantTx pulls, one verify dispatch) fills the other
   live pools; heights run until every pool is empty, then once more
   (128, 32, 1). At the k = 128 height every validator's data root equals
   the CPU path, and the proposer serves 16 samples, 9 namespace reads,
   one /blob/get and its proof pack over HTTP, each verified against the
   data root, with no square build. The down validator restarts on its
   port (load, WAL replay), probes its peers and blocksyncs the heights it
   missed through ProcessProposal (K1 and K2); a fifth validator joins by
   chunked state sync from the others' /sync/*; a SocketNetwork drives two
   heights over four further services with no reactor. It requires round
   0 and no divergence at every height, unmoved loop errors,
   reactor.prewarm_errors, packs.build_errors, consensus.propose_errors,
   edscache.warm_errors, http.500 and process_proposal rejects, and each
   validator's K1 / K2 launches, tallied on its own threads (reactor,
   warmer, handlers), equal to those of the squares it computed (one per
   cache miss) and the provers it built; it prints one `network_plane`
   line (per height: wall time, rounds, gossip bytes; the POST and gossip
   times, blocksync seconds per height, state-sync seconds and chunks,
   sample and read latency, launches by validator, peak memory);
   then, on the same live chain before its services shut down, the light
   plane (`light_plane`): a port NodeService beside the entry validator's
   service (as `validator-serve --http` puts one) answers
   /da/extend_commit of the k = 128 ODS with the committed data root (19
   K1 + 2 K2 cold, none on the repeat) and a verified /da/prove_shares;
   four DASers on cuda (the DASerConfig defaults) sample every height
   with no launch and a restarted one samples nothing; a followed PFB
   namespace's blobs equal the blocks' and an absent one verifies absent,
   with no launch, and a restarted follower reads nothing; a quarter of
   the k = 128 rows withheld is caught by a seeded DASer that reads live
   cells only (a withholder publishes no pack), its 49,152 served cells
   verified on the host and the 64 withheld rows rebuilt on the card
   (recovered, 6 K2 + 27 K1); 8 PFBs through TxClient over
   HttpNodeClient (each gas from a /simulate_tx) commit in round 0 at the entry's
   next slot and read back byte-equal; a certified k = 128 non-codeword
   past the tip (one flipped parity cell, half its row withheld) halts a
   seeded hunter with a BEFP verified on the card (2 K2 + 9 K1), its root
   condemned, a reborn hunter stays halted and the other DASers do not.
   It requires every launch attributed (shim, repair, BEFP, fixture,
   serving provers, the validators' squares), unmoved http.500,
   light.malformed_fraud_proofs, daser.befp_failed,
   daser.pack_chunk_rejected, follower.verify_failures,
   txclient.sim_fallback, loop, reject and error counters, and prints one
   `light_plane` line (per step: host time, launches by source, requests
   and bytes per route; the escalations' fetch, host-verify and repair
   split from the DASers' own spans and repair timer; peak memory);
11. the scenario plane (`scenario_plane`), the reference's scenario matrix
   (bench.py --scenario) through sim.run_scenario on cuda, seed 0, each
   cell tens of real ValidatorNodes and DASers on one seeded virtual
   timeline in a temporary directory: honest, withhold-threshold,
   incorrect-coding and partition-churn under rs2d-nmt, cmt-ldpc and
   pcmt-polar at 8 validators, 64 light nodes and 5 heights, each held to
   tests/test_scenarios.py's verdicts (every height committed; no false
   condemnation; withholding detected with no halt; incorrect coding
   halted by verified fraud proofs, the BEFPs checked with K1 and K2; the
   partition cut and healed); long-soak at its own spec (every resource
   of its soak block churned at least twice, PFB traffic confirmed); the
   rs2d-nmt honest and incorrect-coding specs again on the CPU in this
   process, with verdict bytes equal to the card's; honest under one
   traffic op of txsim's shape (8 lanes of PFBs of 1-3 blobs of 100-250
   KB) with at least 3 heights at the default square cap k = 64; and
   fleet-scale (4 validators, 1,000 continuation-driven lights, its
   heights cut to FLEET_HEIGHTS) twice with byte-identical verdicts. Every
   launch is attributed to a node, a height and a source (the validators'
   own squares, provers and commitments; serving; the malicious fixture;
   the lights' repairs; their fraud-proof checks) and the tally must equal
   the wrappers' counts; http.500, daser.befp_failed,
   daser.pack_chunk_rejected, edscache.warm_errors and
   consensus.propose_errors stay unmoved, and
   light.malformed_fraud_proofs in honest. One `scenario_cell` line per
   cell (wall time, the verdict's metrics, launches by source, peak memory
   above the phase's start, the card's busy share from a torch.profiler
   trace; per height of the traffic cell its k, launches per validator,
   host time and PFBs submitted, accepted and confirmed) and one
   `scenario_plane` line;
12. the command line (`cli_plane`), driven only through `python -m
   celestia_app_tpu_torch` (and the port's own process spawner): init, the
   genesis ceremony of 4 validators (add-account, gentx, collect-gentxs,
   validate), keys and config, once with --device cuda and once with
   --device cpu, whose files must agree apart from the device key and the
   genesis time; e2e-bench at the upstream throughput class (3 autonomous
   validator processes, 5 blocks, one 200 KB blob per PFB, 10 PFBs per
   height, 70 ms gossip latency, target 1.9 MB: some block at >= 90 % of
   it), each validator's exit line naming cuda with K1 launches and at
   least 2 K2 per non-empty height it committed, and every committed
   height's data root recomputed from its home's stored block on the card
   and on the CPU; then 4 autonomous validator processes with their node
   HTTP services under txsim (8 blob and 2 send lanes of 4 txs, PFBs of 1-3
   blobs of 100-250 KB: some height fills a k = 64 square), dasload (1,000
   samplers) and blobload (64 readers of 2 requests) with no chunk
   mismatch, and timeline, whose transfer-ledger leaves carry the reference's site
   names; after a clean stop, blockscan and blocktime over validator 0's
   home equal to the nodes' /block answers. The children's launches are
   the `cli` path of the kernels line; `cli_setup`, `cli_e2e_bench`,
   `cli_network` and `cli_plane` lines;
13. the mesh plane (`mesh_plane`): parallel/sharded_eds.sharded_pipeline
   on meshes that name this card n times, k = 128 (B = 2) at (data, seq) =
   (1, 2), (1, 4) and (2, 2) and k = 256 and 512 at (1, 4), each dispatch's
   EDS, row and column roots and data roots byte-equal to the one-card
   eds.pipeline_batched and its K1 / K2 launches equal to mesh_launches
   (per shard a row and a column pass, one leaf launch and log2(2k) inner
   levels per orientation; one data-root tree), with CUDA-event times and
   peak memory beside the one-card ones; with several cards
   (mesh_over_cards), the same over all of them and the auto rule
   (mesh=None) leaving k = 256 on one card and sharding a k = 512 entry, a
   repair and a batched dispatch over the cards, each with one card's
   roots and the batch's entries on the lead card (not yet run on a
   multi-card host: PERF.md section 7); on one card, mesh_for is None for
   every k; a k = 256 big-block entry through compute_entry(mesh=) with
   share proofs and a namespace read equal to the one-card entry's, no host
   crossing after warm(), and a half-columns repair through the sharded
   batches (8 (1 + log2 2k) K1); an App with a 256 square cap and a mesh
   committing the admission plane's raws in two batched heights with the
   one-card App's block and app hashes, a k = 256 sharded dispatch and no
   host crossing; bench_stream_mesh at k = 256 (3 blocks) with the card's
   idle share; and `multihost-dryrun` on cuda (2 worker processes of 2
   shards, gloo), every host matching its oracle with the launches its
   shards imply; `mesh_shape` lines and one `mesh_plane` line;
14. the two other codecs on the same ODS, on cuda, for cmt-ldpc and
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
15. the scale plane (`scale_plane`): two blocks shaped like the upstream
   e2e big-block manifests (GovMaxSquareSize 512, PFBs of 6 blobs of
   200 KB, seeded), about 8 MB (k = 256) and 64 MB (k = 512), built by
   square.build(max_square_size=512) and run through new_dah_from_ods on
   cuda in the GF(2^16) code (21 and 23 K1 launches, 0 K2), the EDS, axis
   roots and data root equal to the host yardstick (the port's numpy
   Leopard-16 encode, vectorised over the lines of a pass, and hashlib
   trees), with wall and CUDA-event times, the 16-bit product's time and
   share, its bound and the peak memory; the k = 256 block repaired from a
   seeded half of its columns through the 16-bit decode (20 K1) and a
   flipped parity cell under a blind DAH caught as BadEncodingError; the
   k = 512 block repaired with 4 erasure patterns among its rows (22 K1),
   each decode operand 128 MiB, with the repair cache's bytes held to its
   bound and the peak memory; K2
   over batches of B in {1, 3, 8} squares at every k <= 128 against its
   plain version; B = 8 consecutive k = 128 squares planned from one
   seeded candidate list through compute_entries_batched in one dispatch
   (2 K2 and 19 K1), each data root equal to one pipeline call, and ms per
   block at B = 1 and 8; a DeviceEntry of the batch with no host crossing
   after warm(), one eds and one levels crossing at its first share proof,
   and proofs and namespace reads equal to an EdsCacheEntry's; the
   pipeline at k = 128 and 256 queued with no synchronising call; and
   stream_blocks over 8
   seeded k = 128 and 4 seeded k = 256 blocks laid out by square.build,
   roots equal to the serial run, with blocks/s, the serial sum, overlap
   stalls and the card's idle share from a torch.profiler trace; at its
   end the 16-bit operands it cached are freed, so that phase 16's peak
   memory counts what it did before this phase;
16. times with CUDA events after warm-up: the block, each kernel at the main
   path's shapes, each plain version, K2's library yardsticks (fp16
   torch.matmul and torch._int_mm of the same product) and the two-launch
   extension; the tensor-core instructions in K2's SASS (cuobjdump); and a
   torch.profiler trace of the block for its device busy time by kernel.

The line before the last is {"kernels": [...]}, with each kernel's launches
summed over the paths driven in phases 4 to 15 and split by path; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits with code 2 before any of this.
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import dataclasses
import errno
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.parse

import numpy as np
import torch

from celestia_app_tpu_torch import appconsts, cuda_build, faults, obs
from celestia_app_tpu_torch import cli as port_cli_mod
from celestia_app_tpu_torch.chain import admission, consensus, crypto, producer, query, remote_consensus, storage
from celestia_app_tpu_torch.chain import reactor as reactor_mod
from celestia_app_tpu_torch.chain import sync as sync_mod
from celestia_app_tpu_torch.chain import app as app_mod
from celestia_app_tpu_torch.chain import block as block_mod
from celestia_app_tpu_torch.chain import node as node_mod
from celestia_app_tpu_torch.chain import state as state_mod
from celestia_app_tpu_torch.chain import light as light_mod
from celestia_app_tpu_torch.chain import tx as tx_mod
from celestia_app_tpu_torch.client import follower as follower_mod
from celestia_app_tpu_torch.client import tx_client
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
from celestia_app_tpu_torch.obs import xfer
from celestia_app_tpu_torch.net import transport
from celestia_app_tpu_torch.parallel import mesh_engine, streaming
from celestia_app_tpu_torch.das import checkpoint as checkpoint_mod
from celestia_app_tpu_torch.das import daser as daser_mod
from celestia_app_tpu_torch.service import da_service, validator_server
from celestia_app_tpu_torch.service import server as node_server
from celestia_app_tpu_torch.sim import engine as sim_engine
from celestia_app_tpu_torch.sim import scenarios
from celestia_app_tpu_torch.sim import scheduler as sim_scheduler
from celestia_app_tpu_torch.testing import malicious
from celestia_app_tpu_torch.utils import fast_host, merkle_host, nmt_host, telemetry
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
# the upstream e2e big-block manifests (test/e2e/benchmark/throughput.go:
# GovMaxSquareSize 512, blob sequences of 6 blobs of 200 KB, 8 and 64 MB blocks)
BIG_BLOB_BYTES = 200_000
BIG_BLOBS_PER_PFB = 6
BIG_SQUARE_MAX = 512
BIG_BLOCKS = ((256, 8_000_000), (512, 64_000_000))  # (k it needs, blob bytes)
BIG_REPAIR_K = 256
BIG_PATTERN_K = 512
BIG_PATTERNS = 4  # erasure patterns among the rows of the k = 512 repair
BATCH_BLOCKS = 8
K2_BATCH_CHECK_BS = (1, 3, 8)
STREAM_BLOCKS = ((128, 8), (256, 4))  # (k, blocks)
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


def realistic_block(seed: int, max_square: int, fill: float = 1.1) -> tuple[list[bytes], list[square.PfbEntry]]:
    """Seeded mempool contents that overfill a max_square x max_square
    square (`fill` times its capacity in blob bytes): plain txs of 150-400
    bytes, and PFBs of 1-3 blobs each with sizes log-uniform from one share
    (100 B) to 512 KB, under 40 version-0 namespaces."""
    rng = np.random.default_rng(seed)
    txs = [rng.bytes(int(rng.integers(150, 400))) for _ in range(300)]
    namespaces = [namespace.Namespace.v0(rng.bytes(10)) for _ in range(40)]
    capacity = max_square * max_square * appconsts.CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
    pfbs, total = [], 0
    while total < fill * capacity:
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


def counted(wrapper):
    """The kernel wrapper that keeps the launch count, under any
    instrumentation a phase put around it."""
    while hasattr(wrapper, "__wrapped__"):
        wrapper = wrapper.__wrapped__
    return wrapper


def reset_counts() -> None:
    counted(sha256_kernel.compress_words).launches = 0
    counted(rs_kernel.extend_lines).launches = 0


def read_counts() -> dict:
    return {"sha256_compress": counted(sha256_kernel.compress_words).launches,
            "rs_extend_lines": counted(rs_kernel.extend_lines).launches}


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
    # the honest raws come first: the node plane admits them again
    return {"admission": counted, "honest_raws": raws[:traffic["classes"]["send"] + traffic["classes"]["pfb"]]}


# the node plane: one validator (a port Node) proposing and a follower App
NODE_VALIDATORS = 4
NODE_BATCH = 4  # heights per produce_blocks_batched call
NODE_T0 = 1_700_000_000.0
NODE_SPANS = ("prepare_proposal", "square.build", "da.extend_shares", "process_proposal", "finalize_block",
              "commit")
# tests/test_apphash_pin.py's scenario and its five pins
PIN_CHAIN = "test-tpu-1"
APPHASH_PINS = {
    "app_hash_h1_send": "14a2ea9fbee34a25817e5a8bc15747952f5212f645de7e7825f0bf31a6aa214c",
    "app_hash_h2_pfb": "dc565dd8813a1ecb66e7b607c99e6f9a09c7f671e0d2602e552dbb61eedbfcc8",
    "data_root_h2": "865ee5ce8ff37dc2aabb4245833a0d1a57e49f4c1e0aa2dd7c726ade926c8c8a",
    "app_hash_h3_empty": "74a649decdc14c3eaf1f190d6e6355a9cc59ce697ab22943c94834ae6650d146",
    "block_hash_h3": "8110877074f1649f9f983c33c4b547482672d0753862f663d4b977ffcaad6cb9",
}


def launch_delta(before: dict) -> dict:
    return {name: n - before[name] for name, n in read_counts().items()}


def add_counts(into: dict, more: dict) -> dict:
    for name, n in more.items():
        into[name] = into.get(name, 0) + n
    return into


def node_genesis() -> dict:
    """The admission plane's 64 seeded accounts (numbers 0..63 in this
    order, so its signed raws are valid here), 4 seeded validators, app
    version 3 and the main block's k (the v3 cap) as the governance square
    size."""
    accounts = [crypto.PrivateKey.from_seed(b"chip-smoke-account-%d" % i).public_key().address()
                for i in range(ADMISSION_ACCOUNTS)]
    validators = [crypto.PrivateKey.from_seed(b"chip-smoke-validator-%d" % i).public_key().address()
                  for i in range(NODE_VALIDATORS)]
    return {"time_unix": NODE_T0,
            "accounts": [{"address": a.hex(), "balance": 10**12} for a in accounts],
            "validators": [{"operator": v.hex(), "power": 10} for v in validators],
            "gov_max_square_size": K_MAIN}


def node_app(dev: torch.device) -> app_mod.App:
    app = app_mod.App(chain_id="chip-smoke", app_version=3, device=dev)
    app.init_chain(node_genesis())
    return app


def plan_matches(plan: square.Square, block) -> bool:
    """Whether a produced block carries exactly the planned square's txs."""
    pfb_txs = set()
    for raw in block.txs:
        btx = blob.try_unmarshal_blob_tx(raw)
        if btx is not None:
            pfb_txs.add(btx.tx)
    normal = [raw for raw in block.txs if blob.try_unmarshal_blob_tx(raw) is None]
    return normal == list(plan.txs) and pfb_txs == {e.tx for e in plan.pfbs}


def resign_with_flipped_blob(raw: bytes, priv: crypto.PrivateKey, number: int) -> bytes:
    """A BlobTx whose first blob has one byte flipped, its PFB re-signed
    over the flipped blob's true commitment: every tx of the block stays
    valid, and only the square (so the data root) differs from the header."""
    btx = blob.try_unmarshal_blob_tx(raw)
    tx = tx_mod.decode_tx(btx.tx)
    first = btx.blobs[0]
    data = bytearray(first.data)
    data[len(data) // 2] ^= 0x01
    blobs = [dataclasses.replace(first, data=bytes(data)), *btx.blobs[1:]]
    msg = tx.body.msgs[0]
    msg = dataclasses.replace(msg, share_commitments=tuple(commitment.create_commitments(
        blobs, appconsts.SUBTREE_ROOT_THRESHOLD)))
    body = dataclasses.replace(tx.body, msgs=(msg,), chain_id="chip-smoke", account_number=number)
    return blob.marshal_blob_tx(wire_codec.sign_tx_proto(body, priv).encode(), blobs)


def span_ms(app, height: int, names: tuple = NODE_SPANS) -> dict:
    """Host-clock ms of each span of `names` at `height` in the App's
    trace table; a nested span (the layout, the extension) takes the
    height of the span it nests in."""
    rows = app.traces.read("spans", limit=1 << 20)
    by_id = {r["span_id"]: r for r in rows}

    def height_of(r):
        while "height" not in r and r.get("parent_id") in by_id:
            r = by_id[r["parent_id"]]
        return r.get("height")

    return {name: sum(r["dur_ms"] for r in rows if r["name"] == name and height_of(r) == height)
            for name in names}


def pin_scenario(dev: torch.device) -> dict:
    """tests/test_apphash_pin.py's three blocks through a port Node on the
    card, held to the same literal pins."""
    privs = [crypto.PrivateKey.from_seed(bytes([i])) for i in range(3)]
    app = app_mod.App(chain_id=PIN_CHAIN, device=dev)
    app.init_chain({
        "time_unix": NODE_T0,
        "accounts": [{"address": k.public_key().address().hex(), "balance": 10**12} for k in privs],
        "validators": [{"operator": k.public_key().address().hex(), "power": 10} for k in privs]})
    signer = tx_client.Signer(PIN_CHAIN)
    for i, k in enumerate(privs):
        signer.add_account(k, number=i)
    node = node_mod.Node(app)
    a0, a1 = (k.public_key().address() for k in privs[:2])
    rng = np.random.default_rng(99)
    require(node.broadcast_tx(signer.create_tx(a0, [tx_mod.MsgSend(a0, a1, 12345)], fee=2000,
                                               gas_limit=100_000).encode()).code == 0, "pin send refused")
    node.produce_block(t=1_700_000_100.0)
    signer.accounts[a0].sequence += 1
    got = {"app_hash_h1_send": app.last_app_hash.hex()}
    blobs = [blob.Blob(namespace.Namespace.v0(bytes([i + 1]) * 5),
                       rng.integers(0, 256, 777, dtype=np.uint8).tobytes()) for i in range(2)]
    require(node.broadcast_tx(signer.create_pay_for_blobs(a0, blobs, fee=200_000, gas_limit=1_200_000)).code == 0,
            "pin PFB refused")
    blk2, _ = node.produce_block(t=1_700_000_200.0)
    got.update(app_hash_h2_pfb=app.last_app_hash.hex(), data_root_h2=blk2.header.data_hash.hex())
    blk3, _ = node.produce_block(t=1_700_000_300.0)
    got.update(app_hash_h3_empty=app.last_app_hash.hex(), block_hash_h3=blk3.header.hash().hex())
    app.da_warmer.wait_idle()
    require(got == APPHASH_PINS, f"app-hash pins differ on the card: {got}")
    return got


def profile_height(app, block) -> dict:
    """ProcessProposal, FinalizeBlock and Commit of `block` on `app` (and
    its warm) under torch.profiler: the card's busy time against the host
    clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        require(app.process_proposal(block), f"the replay rejected height {block.header.height}: {app.last_reject}")
        app.finalize_block(block)
        app.commit(block)
        app.da_warmer.wait_idle()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "device_ops": sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA),
            "top_ms": [[name[:60], ms] for name, ms in top], "spans_ms": span_ms(app, block.header.height)}


def node_plane(dev: torch.device, honest_raws: list[bytes]) -> dict:
    """One validator on the card: a port Node proposes the admission
    plane's 1,024 MsgSends and the main block's 86 PFBs (164 blobs) through
    broadcast_txs and produce_blocks_batched at the v3 cap, a follower App
    with its own cache processes, finalizes and commits every height, and
    the app hashes agree. Returns the launch counts of the counted runs."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    proposer, follower = node_app(dev), node_app(dev)
    node = node_mod.Node(proposer)
    counts = {"sha256_compress": 0, "rs_extend_lines": 0}
    tel0 = telemetry.snapshot()["counters"]
    scalar0 = admission.counters["admission.sig_scalar_verified"]
    hits0 = admission.counters["admission.sig_cache_hits"]

    before = read_counts()
    results, broadcast_s = timed(lambda: node.broadcast_txs(honest_raws))
    broadcast = launch_delta(before)
    add_counts(counts, broadcast)
    refused = [(i, r.log) for i, r in enumerate(results) if r.code != 0]
    require(not refused, f"broadcast_txs refused {len(refused)} honest txs, first {refused[:2]}")
    require(admission.counters["admission.sig_scalar_verified"] == scalar0,
            "CheckTx verified a signature on the host after batch admission")

    # the proposer's heights: one record per produce_block that the batched
    # call makes, read after the warmer is idle
    heights, plans, calls = [], [], []
    orig_produce = node.produce_block

    def produce_one(t=None):
        proposer.da_warmer.wait_idle()
        c0, x0 = read_counts(), xfer.bytes_crossed()
        h0 = telemetry.snapshot()["counters"]
        out = orig_produce(t=t)
        proposer.da_warmer.wait_idle()
        h1 = telemetry.snapshot()["counters"]
        heights.append({"block": out[0], "results": out[1], "app_hash": proposer.last_app_hash,
                        "proposer": launch_delta(c0),
                        "proposer_crossed_bytes": xfer.bytes_crossed() - x0,
                        "proposer_edscache": {k: h1.get(f"edscache.{k}", 0) - h0.get(f"edscache.{k}", 0)
                                              for k in ("hits", "misses")}})
        return out

    node.produce_block = produce_one
    t = NODE_T0 + 10
    wall0 = time.perf_counter()
    while len(node.pool):
        planned = producer.plan_block_squares(proposer, node.pool.reap(proposer.height), NODE_BATCH)
        plans.extend(planned + [None] * (NODE_BATCH - len(planned)))
        c0 = read_counts()
        if not calls:  # the first call runs under the residency pin
            with xfer.no_implicit_transfers():
                node.produce_blocks_batched(NODE_BATCH, t=t)
        else:
            node.produce_blocks_batched(NODE_BATCH, t=t)
        calls.append(launch_delta(c0))
        t += NODE_BATCH
    produce_one(t=t)  # one empty height
    produce_s = time.perf_counter() - wall0
    node.produce_block = orig_produce
    proposer_scalar = admission.counters["admission.sig_scalar_verified"] - scalar0
    require(proposer_scalar == 0, f"the proposer verified {proposer_scalar} signatures on the host")
    for c in calls:
        add_counts(counts, c)
    add_counts(counts, heights[-1]["proposer"])
    tel1 = telemetry.snapshot()["counters"]
    prewarm_errors = tel1.get("producer.prewarm_errors", 0) - tel0.get("producer.prewarm_errors", 0)
    plan_misses = tel1.get("producer.plan_misses", 0) - tel0.get("producer.plan_misses", 0)
    # a height extends (a plan miss) when its square was neither planned
    # nor already committed at an earlier height (the empty square)
    predicted, resident = 0, set()
    for plan, h in zip(plans, heights):
        root = h["block"].header.data_hash
        if (plan is None or not plan_matches(plan, h["block"])) and root not in resident:
            predicted += 1
        resident.add(root)
    require(prewarm_errors == 0, f"producer.prewarm_errors = {prewarm_errors}")
    require(plan_misses == predicted, f"producer.plan_misses {plan_misses} != {predicted} the plan predicts")
    require(heights[-1]["block"].header.square_size == 1 and not heights[-1]["block"].txs, "the last height is not empty")
    require(sum(len(h["block"].txs) for h in heights) == len(honest_raws), "not every admitted tx was committed")
    require(any(h["block"].header.square_size == K_MAIN for h in heights), f"no height reached k = {K_MAIN}")

    # the follower: a tampered copy of the first PFB height first, then
    # every honest height; equal app hashes, and each data root against
    # the CPU path on the same square
    first_pfb = next(h for h in heights if any(blob.try_unmarshal_blob_tx(r) for r in h["block"].txs))
    keys = [crypto.PrivateKey.from_seed(b"chip-smoke-account-%d" % i) for i in range(ADMISSION_ACCOUNTS)]
    privs = {key.public_key().address(): (key, i) for i, key in enumerate(keys)}
    rows = []
    for h in heights:
        blk = h["block"]
        if h is first_pfb:
            at = next(i for i, r in enumerate(blk.txs) if blob.try_unmarshal_blob_tx(r) is not None)
            signer_addr = tx_mod.decode_tx(blob.try_unmarshal_blob_tx(blk.txs[at]).tx).body.msgs[0].signer
            bad_txs = list(blk.txs)
            bad_txs[at] = resign_with_flipped_blob(blk.txs[at], *privs[signer_addr])
            key = 'process_proposal.rejects{reason="data root mismatch",type="ValueError"}'
            r0 = telemetry.snapshot()["counters"].get(key, 0)
            c0 = read_counts()
            require(not follower.process_proposal(block_mod.Block(header=blk.header, txs=tuple(bad_txs))),
                    "the follower accepted a tampered proposal")
            tampered = {"reject": follower.last_reject, "launches": launch_delta(c0),
                        "counter": telemetry.snapshot()["counters"].get(key, 0) - r0}
            add_counts(counts, tampered["launches"])
            require(tampered["counter"] == 1 and follower.last_reject == "ValueError: data root mismatch",
                    f"tampered proposal rejected for {follower.last_reject!r}")
        follower.da_warmer.wait_idle()
        c0, x0 = read_counts(), xfer.bytes_crossed()
        e0 = telemetry.snapshot()["counters"]
        guard = xfer.no_implicit_transfers() if h is heights[0] else contextlib.nullcontext()
        with guard:
            require(follower.process_proposal(blk), f"the follower rejected honest height {blk.header.height}: {follower.last_reject}")
            res = follower.finalize_block(blk)
            follower.commit(blk)
        follower.da_warmer.wait_idle()
        e1 = telemetry.snapshot()["counters"]
        f_launches = launch_delta(c0)
        add_counts(counts, f_launches)
        require(follower.last_app_hash == h["app_hash"],
                f"height {blk.header.height}: the follower's app hash differs from the proposer's")
        require([(r.code, r.log) for r in res] == [(r.code, r.log) for r in h["results"]],
                f"height {blk.header.height}: follower tx results differ from the proposer's")
        entry = follower.eds_cache.lookup_root(blk.header.data_hash)
        k = blk.header.square_size
        _, _, cpu_root = dah.new_dah_from_ods(entry.eds.squares[:k, :k], device="cpu")
        require(cpu_root == blk.header.data_hash, f"height {blk.header.height}: data root differs from the CPU path")
        rows.append({
            "height": blk.header.height, "k": k, "txs": len(blk.txs),
            "failed_txs": sum(1 for r in res if r.code), "block_bytes": sum(len(r) for r in blk.txs),
            "proposer_launches": h["proposer"], "follower_launches": f_launches,
            "proposer_ms": span_ms(proposer, blk.header.height),
            "follower_ms": span_ms(follower, blk.header.height),
            "proposer_crossed_bytes": h["proposer_crossed_bytes"],
            "follower_crossed_bytes": xfer.bytes_crossed() - x0,
            "follower_gauge_bytes": follower.last_host_bytes_crossed,
            "proposer_edscache": h["proposer_edscache"],
            "follower_edscache": {k2: e1.get(f"edscache.{k2}", 0) - e0.get(f"edscache.{k2}", 0)
                                  for k2 in ("hits", "misses")},
        })
    require(follower.height == proposer.height, "the follower stopped short of the proposer")
    follower_scalar = admission.counters["admission.sig_scalar_verified"] - scalar0
    for row in rows:
        emit("node_height", **row)

    # a third App replays the first height under torch.profiler: the
    # card's busy time and idle share while a follower validates a full block
    replay = node_app(dev)
    first = heights[0]["block"]
    before = read_counts()
    profiled = profile_height(replay, first)
    add_counts(counts, launch_delta(before))
    require(replay.last_app_hash == heights[0]["app_hash"], "the profiled replay's app hash differs")

    before = read_counts()
    pins = pin_scenario(dev)
    add_counts(counts, launch_delta(before))

    # the observatory on the card: a torch.profiler capture and the gauges
    capture = obs.route_profile({"seconds": 0.05})
    require(capture[0] == 200 and os.path.exists(capture[1]["trace"]), f"profile capture: {capture}")
    shutil.rmtree(capture[1]["dir"], ignore_errors=True)
    gauges = telemetry.snapshot()["gauges"]
    require(gauges.get("device.count") == torch.cuda.device_count() and gauges.get("device.memory_allocated_bytes"),
            "the device gauges are missing")
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    tel2 = telemetry.snapshot()["counters"]
    emit("node_plane", heights=len(heights), ks=[r["k"] for r in rows], txs=len(honest_raws),
         broadcast_s=broadcast_s, broadcast_launches=broadcast, produce_s=produce_s,
         blocks_per_s=len(heights) / produce_s, batched_calls=calls, plans=len([p for p in plans if p]),
         plan_misses=plan_misses, plan_misses_predicted=predicted, prewarm_errors=prewarm_errors,
         follower_profile=profiled, tampered=tampered, sig_scalar_verified={"proposer": proposer_scalar, "follower": follower_scalar},
         sig_cache_hits=admission.counters["admission.sig_cache_hits"] - hits0,
         xfer_guard_noop=tel2.get("obs.xfer_guard_noop", 0) - tel0.get("obs.xfer_guard_noop", 0),
         app_hash=proposer.last_app_hash.hex(), pins=pins, launches=counts,
         peak_mib_above_base=peak_mib - base_mib, base_mib=base_mib,
         phase_s=time.perf_counter() - t_phase)
    return {"node_plane": counts}


# the consensus plane: four port validators committing one chain
CONSENSUS_CHAIN = "chip-smoke"  # the admission plane's raws are signed for it
CONSENSUS_EXTRA_SENDS = 4  # through LocalNetwork.broadcast_tx: a scalar CheckTx on every validator
CONSENSUS_SPANS = ("prepare_proposal", "process_proposal", "finalize_block", "commit", "wal.append", "apply")
CONSENSUS_MAX_HEIGHTS = 12


def entry_launches(k: int, level_passes: int) -> dict:
    """K1 and K2 launches of one new square on one validator: its
    compute_entry (2 + log2(2k) + log2(4k) K1, 2 K2) and `level_passes`
    level passes of log2(2k) + 1 K1 (the warmer's row and column passes
    after a commit: 2; a query's row prover: 1)."""
    log2 = int(math.log2(2 * k))
    return {"sha256_compress": (2 + log2 + log2 + 1) + level_passes * (log2 + 1), "rs_extend_lines": 2}


def height_launches(rec: dict) -> dict:
    """A consensus_height record's launches, summed over its validators."""
    return {name: sum(r["launches"][name] for r in rec["rows"].values())
            for name in ("sha256_compress", "rs_extend_lines")}


def consensus_genesis(privs: list) -> dict:
    """The node plane's genesis (its 64 accounts, the v3 cap as the
    governance square size) with each validator's consensus pubkey: a
    rebooted validator verifies its WAL'd certificates against them."""
    gen = node_genesis()
    gen["validators"] = [{"operator": k.public_key().address().hex(), "power": 10,
                          "pubkey": k.public_key().compressed.hex()} for k in privs]
    return gen


class StepMeter:
    """Per-validator accounting of the steps LocalNetwork drives (propose,
    prevote_on, apply): each wrapped step joins every validator's warmer
    before and after it, so its K1 / K2 launches (its own warm included),
    the bytes it crossed (obs/xfer), its cache misses, its sign-state
    fsyncs and its chain-store writes (the block, the commit) are its
    own, though four Apps share the card."""

    def __init__(self):
        self.nodes: list = []
        self.rows: dict = {}

    def idle(self) -> None:
        for n in self.nodes:
            n.app.da_warmer.wait_idle()

    def row(self, name: str) -> dict:
        return self.rows.setdefault(name, {"launches": {"sha256_compress": 0, "rs_extend_lines": 0},
                                           "crossed_bytes": 0, "cache_misses": 0, "sign_state_ms": 0.0,
                                           "sign_state_writes": 0, "save_block_ms": 0.0, "save_commit_ms": 0.0})

    def add(self, node) -> None:
        self.nodes.append(node)
        for step in ("propose", "prevote_on", "apply"):
            orig = getattr(node, step)

            def run(*a, _orig=orig, _step=step, **kw):
                self.idle()
                c0, x0, m0 = read_counts(), xfer.bytes_crossed(), node.app.eds_cache.misses
                out = _orig(*a, **kw)
                self.idle()
                row = self.row(node.name)
                add_counts(row["launches"], launch_delta(c0))
                row["crossed_bytes"] += xfer.bytes_crossed() - x0
                row["cache_misses"] += node.app.eds_cache.misses - m0
                if _step == "prevote_on":
                    row["prevote"] = out
                return out

            setattr(node, step, run)
        for owner, method, key in ((node, "_persist_sign_state", "sign_state_ms"),
                                   (node.app.db, "save_block", "save_block_ms"),
                                   (node.app.db, "save_commit", "save_commit_ms")):
            orig = getattr(owner, method)

            def timed_write(*a, _orig=orig, _key=key, **kw):
                t0 = time.perf_counter()
                _orig(*a, **kw)
                row = self.row(node.name)
                row[_key] += (time.perf_counter() - t0) * 1e3
                if _key == "sign_state_ms":
                    row["sign_state_writes"] += 1

            setattr(owner, method, timed_write)


def consensus_height(net, meter: StepMeter, t: float, counters0: dict) -> dict:
    """One LocalNetwork height: certified in round 0 with every prevote and
    precommit non-nil, every validator accepting, and each validator's
    launches those of the new squares its cache missed."""
    meter.rows = {}
    t0 = time.perf_counter()
    blk, cert = net.produce_height(t)
    meter.idle()
    secs = time.perf_counter() - t0
    require(blk is not None, f"height {net.nodes[0].app.height + 1}: a nil round ({net._round})")
    h, bh, k = blk.header.height, blk.header.hash(), blk.header.square_size
    require(cert.round == 0, f"height {h} certified in round {cert.round}")
    require(len(cert.votes) == len(net.nodes) and all(v.block_hash == bh for v in cert.votes),
            f"height {h}: a nil or missing precommit")
    require(sorted(meter.rows) == sorted(n.name for n in net.nodes)
            and all(r["prevote"].block_hash == bh for r in meter.rows.values()), f"height {h}: a nil prevote")
    rejects = {n.name: n.app.last_reject for n in net.nodes if n.app.last_reject is not None}
    require(not rejects, f"height {h}: ProcessProposal rejected: {rejects}")
    tel = telemetry.snapshot()["counters"]
    for name in ("consensus.propose_errors", "edscache.warm_errors"):
        require(tel.get(name, 0) == counters0.get(name, 0), f"height {h}: {name} moved")
    for n in net.nodes:
        row = meter.rows[n.name]
        require(row["cache_misses"] <= 1, f"height {h}: {n.name} missed its cache {row['cache_misses']} times")
        want = {name: c * row["cache_misses"] for name, c in entry_launches(k, 2).items()}
        require(row["launches"] == want, f"height {h}: {n.name} launched {row['launches']}, not {want}")
    return {"block": blk, "k": k, "s": secs, "app_hash": net.nodes[0].app.last_app_hash,
            "rows": {name: {key: v for key, v in r.items() if key != "prevote"} for name, r in meter.rows.items()}}


def emit_height(net, rec: dict) -> None:
    blk = rec["block"]
    emit("consensus_height", height=blk.header.height, k=rec["k"], txs=len(blk.txs),
         proposer=next(n.name for n in net.nodes if n.address == blk.header.proposer), s=rec["s"],
         rows=rec["rows"], ms={n.name: span_ms(n.app, blk.header.height, CONSENSUS_SPANS) for n in net.nodes})


def check_data_root(app, blk):
    """The committed square's data root on the port's CPU path; returns
    the live DAH."""
    entry = app.eds_cache.lookup_root(blk.header.data_hash)
    k = blk.header.square_size
    _, _, cpu_root = dah.new_dah_from_ods(entry.eds.squares[:k, :k], device="cpu")
    require(cpu_root == blk.header.data_hash, f"height {blk.header.height}: data root differs from the CPU path")
    return entry.dah


def extra_sends(n_honest: int) -> list[bytes]:
    """CONSENSUS_EXTRA_SENDS MsgSends from the last accounts, at the
    sequence after their admitted sends and PFBs."""
    n_pfbs = n_honest - ADMISSION_ACCOUNTS * SENDS_PER_ACCOUNT
    out = []
    for i in range(ADMISSION_ACCOUNTS - CONSENSUS_EXTRA_SENDS, ADMISSION_ACCOUNTS):
        priv = crypto.PrivateKey.from_seed(b"chip-smoke-account-%d" % i)
        seq = SENDS_PER_ACCOUNT + len(range(i, n_pfbs, ADMISSION_ACCOUNTS))
        to = crypto.PrivateKey.from_seed(b"chip-smoke-account-0").public_key().address()
        body = send_body(CONSENSUS_CHAIN, priv.public_key().address(), to, i, seq)
        out.append(wire_codec.sign_tx_proto(body, priv).encode())
    return out


def query_rebuilt(router, live_app, live, hq: int, honest_raws: list[bytes]) -> dict:
    """Every proof route of the rebuilt validator's QueryRouter at height
    `hq`, verified against the stored header's data root and the live
    validators' DAH `live`. Returns the launches of the first route and of
    the rest."""
    app = router.app
    header = app.db.load_block(hq).header
    root = header.data_hash
    k = header.square_size
    c0 = read_counts()
    doc, first_s = timed(lambda: router.query("custom/dah", {"height": hq}))
    first = launch_delta(c0)
    d = dah.DataAvailabilityHeader(row_roots=tuple(bytes.fromhex(r) for r in doc["row_roots"]),
                                   col_roots=tuple(bytes.fromhex(r) for r in doc["col_roots"]))
    require(d.row_roots == live.row_roots and d.col_roots == live.col_roots and d.hash() == root,
            "the rebuilt validator's DAH differs from the live one")
    c0 = read_counts()
    _, sq = query.rebuild_square(app, hq)
    first_blob = sq.pfbs[0].blobs[0]
    start, end = proof.blob_share_range(sq, 0, 0)
    verified = 0
    for path, data in (("custom/shareInclusionProof", {"height": hq, "start": start, "end": end,
                                                        "namespace": first_blob.namespace.raw.hex()}),
                       ("custom/txInclusionProof", {"height": hq, "tx_index": len(sq.txs)})):
        out = router.query(path, data)
        pf = query.share_proof_from_json(out["proof"])
        require(out["data_root"] == root.hex() and pf.verify(root), f"{path} does not verify")
        verified += 1
    corner = 2 * k - 1
    cell = router.query("custom/sampleCell", {"height": hq, "row": corner, "col": corner})
    pf = nmt_host.NmtRangeProof(**{**cell["proof"], "nodes": [base64.b64decode(n) for n in cell["proof"]["nodes"]]})
    require(sampling.verify_sample(d, corner, corner, base64.b64decode(cell["share"]), pf),
            "the parity corner does not verify")
    present = sorted({b.namespace.raw for e in sq.pfbs for b in e.blobs})
    absent = next(ns[:-1] + bytes([ns[-1] + 1]) for ns in present
                  if ns[-1] < 255 and ns[:-1] + bytes([ns[-1] + 1]) not in present)
    for ns, want in ((first_blob.namespace.raw, True), (absent, False)):
        out = router.query("custom/namespaceData", {"height": hq, "namespace": ns.hex()})
        nd = namespace_data.NamespaceData(
            namespace=ns, shares=[base64.b64decode(s) for s in out["shares"]],
            proof=query.share_proof_from_json(out["proof"]) if out["proof"] else None)
        require(out["present"] is want and namespace_data.verify_namespace_data(d, ns, nd),
                f"namespaceData {'present' if want else 'absent'} does not verify")
    verified += 3
    txs_at = {hashlib.sha256(raw).hexdigest() for raw in app.db.load_block(hq).txs}
    raw = next(r for r in honest_raws if hashlib.sha256(r).hexdigest() in txs_at)
    found = router.query("tx", {"hash": hashlib.sha256(raw).hexdigest()})
    require(found["found"] and found["height"] == hq, f"tx route: {found}")
    status = router.query("status", {})
    require(status["height"] == app.height and status["last_app_hash"] == app.last_app_hash.hex(), "status route")
    addr0 = crypto.PrivateKey.from_seed(b"chip-smoke-account-0").public_key().address().hex()
    balance = router.query("bank/balance", {"address": addr0})
    require(balance == query.QueryRouter(live_app).query("bank/balance", {"address": addr0}), "bank/balance")
    return {"first_route": first, "first_route_s": first_s, "later_routes": launch_delta(c0),
            "proofs_verified": verified, "k": k}


def consensus_plane(dev: torch.device, honest_raws: list[bytes]) -> dict:
    """Four port validators on the card commit the admission plane's
    1,024 MsgSends and 86 PFBs under Tendermint's two vote phases
    (LocalNetwork), then a crash after the WAL record and its replay, the
    queries of the rebuilt validator, an equivocation and a state-synced
    joiner. Returns the launch counts of the phase."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    counts = {"sha256_compress": 0, "rs_extend_lines": 0}
    home = tempfile.mkdtemp(prefix="chip-smoke-consensus-")
    privs = [crypto.PrivateKey.from_seed(b"chip-smoke-validator-%d" % i) for i in range(NODE_VALIDATORS)]
    gen = consensus_genesis(privs)

    def validator(name, priv, data_dir=None):
        return consensus.ValidatorNode(name, priv, gen, CONSENSUS_CHAIN, data_dir=data_dir, device=dev,
                                       app_version=3)

    nodes = [validator(f"val{i}", k, os.path.join(home, f"val{i}")) for i, k in enumerate(privs)]
    net = consensus.LocalNetwork(nodes)
    meter = StepMeter()
    for n in net.nodes:
        meter.add(n)
    counters0 = telemetry.snapshot()["counters"]
    adm0 = dict(admission.counters)
    try:
        # batched admission on every validator: one verify dispatch and the
        # commitments' K1 launches each
        admitted = {}
        for n in net.nodes:
            c0 = read_counts()
            results, secs = timed(lambda: n.add_txs(honest_raws))
            n.app.da_warmer.wait_idle()
            refused = [(i, r.log) for i, r in enumerate(results) if r.code != 0]
            require(not refused, f"{n.name} refused {len(refused)} honest txs, first {refused[:2]}")
            admitted[n.name] = {"s": secs, "launches": launch_delta(c0)}
            add_counts(counts, admitted[n.name]["launches"])
        scalar = admission.counters["admission.sig_scalar_verified"] - adm0["admission.sig_scalar_verified"]
        require(scalar == 0, f"admission verified {scalar} signatures on the host")

        heights, t = [], NODE_T0 + 10
        wall0 = time.perf_counter()
        while any(len(n.pool) for n in net.nodes) or not heights or heights[-1]["block"].txs:
            require(len(heights) < CONSENSUS_MAX_HEIGHTS, "the mempools never drained")
            heights.append(consensus_height(net, meter, t, counters0))
            t += 1
        heights_s = time.perf_counter() - wall0
        require(sum(len(h["block"].txs) for h in heights) == len(honest_raws), "not every admitted tx was committed")
        require(any(h["k"] == K_MAIN for h in heights), f"no height reached k = {K_MAIN}")
        for h in heights:
            add_counts(counts, height_launches(h))
            h["dah"] = check_data_root(net.nodes[0].app, h["block"])
            emit_height(net, h)

        # a fifth App replays the heights up to the first k = 128 one and
        # validates that one under torch.profiler
        replay = app_mod.App(chain_id=CONSENSUS_CHAIN, app_version=3, device=dev)
        replay.init_chain(gen)
        c0 = read_counts()
        for h in heights:
            if h["k"] == K_MAIN:
                profiled = profile_height(replay, h["block"])
                require(replay.last_app_hash == h["app_hash"], "the profiled replay's app hash differs")
                break
            require(replay.process_proposal(h["block"]), f"the replay rejected: {replay.last_reject}")
            replay.finalize_block(h["block"])
            replay.commit(h["block"])
        replay.da_warmer.wait_idle()
        add_counts(counts, launch_delta(c0))

        # crash after the WAL record: the validator applied last stops at
        # consensus.post_wal_pre_apply on a height carrying txs that came
        # through broadcast_tx; it is rebuilt from its data_dir with its
        # commits wiped, and replays the WAL
        victim = net.nodes[-1]
        extras = extra_sends(len(honest_raws))
        for raw in extras:
            require(all(net.broadcast_tx_all(raw)), "a validator refused an extra send")
        crash_h = net.nodes[0].app.height + 1
        fault = faults.arm_from_spec([{"point": "consensus.post_wal_pre_apply", "action": "error", "count": 1,
                                       "match": {"node": f"^{victim.name}$", "height": f"^{crash_h}$"}}])
        c0 = read_counts()
        try:
            net.produce_height(t)
            require(False, "the armed fault did not fire")
        except OSError as e:
            require("post_wal_pre_apply" in str(e), f"the crash height raised {e!r}")
        finally:
            faults.disarm(fault[0])
        t += 1
        meter.idle()
        crash_launches = launch_delta(c0)
        add_counts(counts, crash_launches)
        require([n.app.height for n in net.nodes] == [crash_h] * 3 + [crash_h - 1],
                f"heights after the crash: {[n.app.height for n in net.nodes]}")
        require(os.path.exists(victim._wal_path(crash_h)), "no WAL record of the crash height")
        for n in net.nodes:
            n.clear_lock()
        data_dir = victim.app.db.dir
        victim.app.close()
        storage.wipe_commits(data_dir)
        reborn = validator(victim.name, victim.priv, data_dir)
        require(reborn.app.height == 0, "the wiped validator did not restart at genesis")
        c0, d0 = read_counts(), admission.counters["admission.batch_dispatches"]
        replayed, replay_s = timed(reborn.replay_wal)
        reborn.app.da_warmer.wait_idle()
        replay_launches = launch_delta(c0)
        add_counts(counts, replay_launches)
        require(replayed == crash_h and reborn.app.last_app_hash == net.nodes[0].app.last_app_hash,
                f"the replay ({replayed} heights) did not converge to the network's app hash")
        replay_dispatches = admission.counters["admission.batch_dispatches"] - d0
        require(replay_dispatches >= 1, "the replay verified no signature batch on the card")

        # the rebuilt validator serves the k = 128 height from a cold cache
        k128 = next(h for h in heights if h["k"] == K_MAIN)
        router = query.QueryRouter(reborn.app)
        queries = query_rebuilt(router, net.nodes[0].app, k128["dah"], k128["block"].header.height, honest_raws)
        add_counts(counts, queries["first_route"])
        add_counts(counts, queries["later_routes"])
        want = entry_launches(K_MAIN, 1)
        require(queries["first_route"] == want, f"the first route launched {queries['first_route']}, not {want}")
        require(queries["later_routes"] == {"sha256_compress": 0, "rs_extend_lines": 0},
                f"later routes launched {queries['later_routes']}")

        # the network goes on with the rebuilt validator; one validator
        # signs a conflicting prevote, gossiped a height late
        net = consensus.LocalNetwork(net.nodes[:-1] + [reborn])
        meter.nodes.remove(victim)
        meter.add(reborn)
        before = consensus_height(net, meter, t, counters0)
        byz = net.nodes[1]
        h = before["block"].header.height
        fake = hashlib.sha256(b"chip-smoke-equivocation").digest()
        net.inject_vote(consensus.Vote(h, fake, byz.address, byz.priv.sign(
            consensus.Vote.sign_bytes(CONSENSUS_CHAIN, h, fake, "prevote", 0)), "prevote", 0))
        after = consensus_height(net, meter, t + 1, counters0)
        for rec in (before, after):
            add_counts(counts, height_launches(rec))
            emit_height(net, rec)
        for n in net.nodes:
            ctx = state_mod.Context(n.app.store, state_mod.InfiniteGasMeter(), n.app.height, 0, CONSENSUS_CHAIN,
                                    n.app.app_version)
            require(n.app.slashing.info(ctx, byz.address)["tombstoned"]
                    and n.app.staking.validator(ctx, byz.address)["jailed"],
                    f"{n.name} did not tombstone the equivocator")

        # a fifth validator joins by state sync
        manifest, chunks = net.nodes[0].snapshot_chunks()
        joiner = validator("joiner", crypto.PrivateKey.from_seed(b"chip-smoke-joiner"))
        _, sync_s = timed(lambda: consensus.state_sync_bootstrap(joiner, manifest, chunks))
        require(joiner.app.height == net.nodes[0].app.height
                and joiner.app.last_app_hash == net.nodes[0].app.last_app_hash, "the joiner did not adopt the app hash")
        bad = list(chunks)
        part = json.loads(bad[0])
        part[0][1] = "ff" + part[0][1][2:]
        bad[0] = json.dumps(part, sort_keys=True).encode()
        refusals = {}
        for what, man in (("hash mismatch", manifest),
                          ("app hash", dict(manifest, chunk_hashes=[hashlib.sha256(c).hexdigest() for c in bad]))):
            try:
                consensus.state_sync_bootstrap(validator("joiner2", crypto.PrivateKey.from_seed(b"x")), man, bad)
                refusals[what] = None
            except ValueError as e:
                refusals[what] = str(e)
            require(refusals[what] is not None and what in refusals[what], f"a tampered snapshot: {refusals[what]!r}")
        torch.cuda.synchronize()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        emit("consensus_plane", validators=len(nodes), heights=len(heights), ks=[h["k"] for h in heights],
             txs=len(honest_raws), extra_sends=len(extras), admission=admitted, heights_s=heights_s,
             blocks_per_s=len(heights) / heights_s, k128_height_s=k128["s"], follower_profile=profiled,
             crash={"height": crash_h, "victim": victim.name, "height_launches": crash_launches,
                    "replayed": replayed, "replay_s": replay_s,
                    "launches": replay_launches, "verify_dispatches": replay_dispatches},
             queries=queries, equivocator=byz.name, state_sync={"chunks": len(chunks), "s": sync_s,
                                                                "refusals": refusals},
             sig_scalar_verified=admission.counters["admission.sig_scalar_verified"]
             - adm0["admission.sig_scalar_verified"],
             app_hash=net.nodes[0].app.last_app_hash.hex(), launches=counts,
             peak_mib_above_base=peak_mib - base_mib, base_mib=base_mib, phase_s=time.perf_counter() - t_phase)
    finally:
        for n in meter.nodes:
            n.app.da_warmer.wait_idle()
            n.app.close()
        shutil.rmtree(home, ignore_errors=True)
    return counts


NETWORK_SNAPSHOT_INTERVAL = 2  # the one ReactorConfig field off the reference's defaults
NETWORK_SAMPLES = 16
NETWORK_SOCKET_SENDS = 8
NETWORK_WAIT_S = 120.0  # the deadline of every wait of the phase
NETWORK_ZERO = ("reactor.prewarm_errors", "packs.build_errors", "blobpacks.build_errors",
                "consensus.propose_errors", "edscache.warm_errors", "http.500")


class LaunchTally:
    """Attribution of K1 / K2 launches to validators across threads.

    The phase replaces the kernel wrappers' module attributes with
    functions that call them (their own counters stay the launch counts
    the script reports) and add one to the tally of the calling thread's
    (validator, source). A validator's reactor thread, warmer thread and
    the handler threads of its admission, proposals, votes and applies
    carry its name; the source is the compute_entry of a new square, the
    level pass of a prover, or a batch of blob commitments. Every entry
    computed and every prover built is recorded with its k, so each
    validator's launches can be held against those its cache misses imply;
    a launch outside these sources counts under (name, None)."""

    KERNELS = ("sha256_compress", "rs_extend_lines")

    @staticmethod
    def on_card(t: torch.Tensor) -> bool:
        """A call launches (and the wrapper counts) only on a CUDA tensor."""
        return t.device.type == "cuda"

    def __init__(self):
        self.local = threading.local()
        self.lock = threading.Lock()
        self.counts: dict = {}  # (who, what) -> launches
        self.entries: dict = {}  # who -> [k of each square computed]
        self.provers: dict = {}  # who -> [k of each level pass]
        self.undo: list = []

    @contextlib.contextmanager
    def tag(self, **kw):
        old = {key: getattr(self.local, key, None) for key in kw}
        for key, value in kw.items():
            setattr(self.local, key, value)
        try:
            yield
        finally:
            for key, value in old.items():
                setattr(self.local, key, value)

    def _count(self, kernel: str) -> None:
        key = (getattr(self.local, "who", None), getattr(self.local, "what", None))
        with self.lock:
            self.counts.setdefault(key, dict.fromkeys(self.KERNELS, 0))[kernel] += 1

    def _record(self, table: dict, k: int) -> None:
        with self.lock:
            table.setdefault(getattr(self.local, "who", None), []).append(k)

    def _patch(self, owner, name: str, make) -> None:
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self.undo.append((owner, name, orig))

    def install(self) -> None:
        def kernel(name, tensor_of):
            def make(orig):
                def tally(*a, **kw):
                    if self.on_card(tensor_of(*a, **kw)):
                        self._count(name)
                return TalliedKernel(orig, tally)
            return make

        def entry(orig):
            def run(ods, device=None, scheme=codec.RS2D_NAME, mesh=None):
                with self.tag(what="entry"):
                    out = orig(ods, device, scheme, mesh)
                self._record(self.entries, out.k)
                return out
            return run

        def prover(orig):
            def run(eds_, dah_, levels=None, device=None):
                if levels is not None:
                    return orig(eds_, dah_, levels=levels, device=device)
                with self.tag(what="levels"):
                    out = orig(eds_, dah_, levels=levels, device=device)
                self._record(self.provers, eds_.width // 2)
                return out
            return run

        def commitments(orig):
            def run(*a, **kw):
                with self.tag(what="commitments"):
                    return orig(*a, **kw)
            return run

        self._patch(sha256_kernel, "compress_words", kernel("sha256_compress", lambda blocks: blocks))
        self._patch(rs_kernel, "extend_lines", kernel("rs_extend_lines", lambda groups, operand: operand))
        self._patch(edscache, "compute_entry", entry)
        self._patch(edscache, "build_block_prover", prover)
        self._patch(commitment_device, "commitments_device", commitments)

    def remove(self) -> None:
        while self.undo:
            owner, name, orig = self.undo.pop()
            setattr(owner, name, orig)

    def validator(self, vnode) -> None:
        """Tag the work `vnode` does on any thread with its name."""
        who = vnode.name

        def tagged(orig):
            def run(*a, **kw):
                with self.tag(who=who):
                    return orig(*a, **kw)
            return run

        for step in ("add_tx", "add_txs", "prevalidate_txs", "propose", "prevote_on", "apply"):
            setattr(vnode, step, tagged(getattr(vnode, step)))
        warmer = vnode.app.da_warmer
        warmer._run = tagged(warmer._run)

    def expected(self, who: str) -> dict:
        """The launches the squares and provers of `who` imply."""
        k1 = sum(entry_launches(k, 0)["sha256_compress"] for k in self.entries.get(who, []))
        k1 += sum(int(math.log2(2 * k)) + 1 for k in self.provers.get(who, []))
        return {"sha256_compress": k1, "rs_extend_lines": 2 * len(self.entries.get(who, []))}

    def of(self, who: str) -> dict:
        """The launches counted on `who`'s threads, by source."""
        return {str(what): dict(n) for (w, what), n in self.counts.items() if w == who}


class TalliedKernel:
    """Stands in for a kernel wrapper under the network plane's tally: calls
    it, then tallies the call. Its ``launches`` is the wrapper's own count
    (the wrapper adds to it through its module attribute, so the count
    reads and writes pass through to the wrapper)."""

    def __init__(self, wrapped, tally):
        self.__wrapped__ = wrapped
        self._tally = tally

    def __call__(self, *a, **kw):
        out = self.__wrapped__(*a, **kw)
        self._tally(*a, **kw)
        return out

    @property
    def launches(self) -> int:
        return self.__wrapped__.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.__wrapped__.launches = n


class StepGate:
    """Holds a reactor's round loop at the start of each step until the
    phase grants it one, so heights run when the phase says (the reactor's
    own loop, rounds, gossip and timeouts run unchanged inside a step)."""

    def __init__(self, tally: LaunchTally, reactor):
        self.reactor = reactor
        self.tokens = threading.Semaphore(0)
        self.granted = 0
        self.taken = 0
        self.steps = 0
        orig = reactor._step_traced

        def gated():
            while not reactor._stop.is_set():
                if self.tokens.acquire(timeout=0.1):
                    self.taken += 1
                    break
            else:
                return False
            try:
                with tally.tag(who=reactor.vnode.name):
                    return orig()
            finally:
                self.steps += 1

        reactor._step_traced = gated

    def idle(self) -> bool:
        return self.taken == self.granted and self.steps == self.taken

    def grant(self) -> None:
        self.granted += 1
        self.tokens.release()


def network_reactor(tally: LaunchTally, svc, peers: list[str]):
    """svc.attach_reactor with the reference's ReactorConfig defaults (but
    snapshot_interval), gated before its thread starts."""
    reactor = reactor_mod.ConsensusReactor(
        svc.vnode, peers, svc.lock, reactor_mod.ReactorConfig(snapshot_interval=NETWORK_SNAPSHOT_INTERVAL),
        self_url=f"http://127.0.0.1:{svc.port}")
    gate = StepGate(tally, reactor)
    svc.reactor = reactor
    reactor.start()
    return gate


def run_height(gates: list, target: int) -> float:
    """Grant steps to every gated reactor below `target` whenever it is
    idle, until every one has committed `target`; returns the seconds."""
    t0 = time.perf_counter()
    deadline = time.monotonic() + NETWORK_WAIT_S
    while any(g.reactor.vnode.app.height < target for g in gates):
        require(time.monotonic() < deadline,
                f"height {target} not reached: {[g.reactor.vnode.app.height for g in gates]}")
        errors = {g.reactor.vnode.name: g.reactor.loop_errors for g in gates if g.reactor.loop_errors}
        require(not errors, f"height {target}: reactor loop errors {errors}")
        for g in gates:
            if g.idle() and g.reactor.vnode.app.height < target:
                g.grant()
        time.sleep(0.002)
    while not all(g.idle() for g in gates):
        require(time.monotonic() < deadline, f"height {target}: a step did not end")
        time.sleep(0.002)
    return time.perf_counter() - t0


class GossipBytes:
    """The HTTP traffic of the process, read off the requests the port's
    transport hands to urllib (no second encoding): per route path, the
    requests, the request body bytes and the response Content-Length
    (`routes`; `add` books a client that speaks http.client); of the peer
    traffic, the bodies POSTed on /gossip/* by height (tx announces under
    "tx"), and the Content-Length of the bodies that tx pulls and
    commit-range pulls receive."""

    HEIGHT = re.compile(rb'"height": (\d+)')

    def __init__(self):
        self.lock = threading.Lock()
        self.sent: dict = {}
        self.pulled: dict = {}
        self.routes: dict = {}
        self.orig = None

    def add(self, path: str, sent: int, received: int) -> None:
        with self.lock:
            row = self.routes.setdefault(path, [0, 0, 0])
            row[0] += 1
            row[1] += sent
            row[2] += received

    def snapshot(self) -> dict:
        with self.lock:
            return {k: list(v) for k, v in self.routes.items()}

    def since(self, before: dict) -> dict:
        """{path: [requests, bytes sent, bytes received]} since `before`."""
        out = {}
        for path, row in self.snapshot().items():
            diff = [a - b for a, b in zip(row, before.get(path, [0, 0, 0]))]
            if any(diff):
                out[path] = diff
        return out

    def install(self) -> None:
        import urllib.request

        self.orig = orig = urllib.request.urlopen

        def urlopen(req, *a, **kw):
            resp = orig(req, *a, **kw)
            path = urllib.parse.urlparse(getattr(req, "full_url", req)).path
            self.add(path, len(getattr(req, "data", None) or b""), int(resp.headers.get("Content-Length", 0)))
            if path.startswith("/gossip/"):
                with self.lock:
                    if getattr(req, "data", None):
                        m = self.HEIGHT.search(req.data[:400])
                        key = int(m.group(1)) if m else "tx"
                        self.sent[key] = self.sent.get(key, 0) + len(req.data)
                    else:
                        self.pulled[path] = self.pulled.get(path, 0) + int(resp.headers.get("Content-Length", 0))
            return resp

        urllib.request.urlopen = urlopen

    def remove(self) -> None:
        import urllib.request

        if self.orig is not None:
            urllib.request.urlopen = self.orig


def bind_again(make):
    """(make(), retries): a service rebound on a port it held a moment ago,
    retried while another socket of the process (an ephemeral source port
    of a client connection still open) holds that port."""
    deadline = time.monotonic() + NETWORK_WAIT_S
    retries = 0
    while True:
        try:
            return make(), retries
        except OSError as e:
            if e.errno != errno.EADDRINUSE or time.monotonic() > deadline:
                raise
            retries += 1
            time.sleep(0.2)


def network_validator(name: str, priv, gen: dict, home: str, dev: torch.device, **kw):
    return consensus.ValidatorNode(name, priv, gen, CONSENSUS_CHAIN, data_dir=os.path.join(home, name, "data"),
                                   device=dev, app_version=3, **kw)


def serve_k128(url: str, app, hk: int, sq_namespaces: list[bytes]) -> dict:
    """Samples and namespace reads of height `hk` over HTTP, each verified
    against the stored header's data root; the pack route's manifest and
    a chunk against its hash. Returns the latencies."""
    header = app.db.load_block(hk).header
    root = header.data_hash
    t0 = time.perf_counter()
    doc = transport.request_json(url, f"/das/header?height={hk}")
    header_s = time.perf_counter() - t0
    d = dah.DataAvailabilityHeader(row_roots=tuple(bytes.fromhex(r) for r in doc["row_roots"]),
                                   col_roots=tuple(bytes.fromhex(r) for r in doc["col_roots"]))
    require(d.hash() == root, "/das/header does not bind to the data root")
    w = 2 * header.square_size
    rng = np.random.default_rng(SEED + 10)
    cells = [[int(r), int(c)] for r, c in rng.integers(0, w, (NETWORK_SAMPLES, 2))]
    t0 = time.perf_counter()
    out = transport.request_json(url, "/das/samples", {"height": hk, "cells": cells})
    samples_s = time.perf_counter() - t0
    for s in out["samples"]:
        pf = nmt_host.NmtRangeProof(**{**s["proof"], "nodes": [base64.b64decode(n) for n in s["proof"]["nodes"]]})
        require(sampling.verify_sample(d, s["row"], s["col"], base64.b64decode(s["share"]), pf),
                f"sample ({s['row']}, {s['col']}) does not verify")
    absent = next(ns[:-1] + bytes([ns[-1] + 1]) for ns in sq_namespaces
                  if ns[-1] < 255 and ns[:-1] + bytes([ns[-1] + 1]) not in sq_namespaces)
    queries = [{"height": hk, "namespace": ns.hex()} for ns in sq_namespaces[:8] + [absent]]
    t0 = time.perf_counter()
    got = transport.request_json(url, "/blob/namespaces", {"queries": queries})["queries"]
    reads_s = time.perf_counter() - t0
    for q, r in zip(queries, got):
        ns = bytes.fromhex(q["namespace"])
        nd = namespace_data.NamespaceData(namespace=ns, shares=[base64.b64decode(s) for s in r["shares"]],
                                          proof=query.share_proof_from_json(r["proof"]) if r["proof"] else None)
        require(r["present"] is (ns != absent) and namespace_data.verify_namespace_data(d, ns, nd),
                f"namespace read {q['namespace'][:16]} does not verify")
    t0 = time.perf_counter()
    one = transport.request_json(url, f"/blob/get?height={hk}&namespace={sq_namespaces[0].hex()}")
    get_s = time.perf_counter() - t0
    require(one["present"] and one["data_root"] == root.hex(), "/blob/get")
    manifest = transport.request_json(url, f"/das/pack?height={hk}")
    chunk = transport.DEFAULT.get(url, f"/das/pack/chunk?height={hk}&index=0", raw=True)
    require(manifest["data_root"] == root.hex() and manifest["n_cells"] == w * w
            and hashlib.sha256(chunk).hexdigest() == manifest["chunk_hashes"][0], "the k = 128 proof pack")
    return {"header_ms": header_s * 1e3, "samples": len(cells), "samples_ms": samples_s * 1e3,
            "namespaces": len(queries), "namespaces_ms": reads_s * 1e3, "blob_get_ms": get_s * 1e3,
            "pack_chunks": manifest["n_chunks"]}


def socket_network_heights(dev: torch.device, gen: dict, privs: list, home: str, tally: LaunchTally) -> dict:
    """Two heights of a port SocketNetwork over four further services that
    run no reactor: the round schedule of chain/remote_consensus.py."""
    nodes = [network_validator(f"sock{i}", k, gen, home, dev) for i, k in enumerate(privs)]
    for n in nodes:
        tally.validator(n)
    svcs = [validator_server.ValidatorService(n) for n in nodes]
    try:
        for s in svcs:
            s.serve_background()
        net = remote_consensus.SocketNetwork(
            [remote_consensus.RemoteValidator(f"http://127.0.0.1:{s.port}") for s in svcs], gen, CONSENSUS_CHAIN)
        to = crypto.PrivateKey.from_seed(b"chip-smoke-account-0").public_key().address()
        for i in range(NETWORK_SOCKET_SENDS):
            priv = crypto.PrivateKey.from_seed(b"chip-smoke-account-%d" % i)
            raw = wire_codec.sign_tx_proto(send_body(CONSENSUS_CHAIN, priv.public_key().address(), to, i, 0),
                                           priv).encode()
            require(net.broadcast_tx(raw), f"the socket network refused send {i}")
        out = []
        for h in (1, 2):
            t0 = time.perf_counter()
            height, app_hash = net.produce_height(NODE_T0 + 10 + h)
            out.append({"height": height, "s": time.perf_counter() - t0, "app_hash": app_hash,
                        "k": nodes[0].app.db.load_block(h).header.square_size if height else None})
            require(height == h, f"the socket network failed height {h}")
        for n in nodes:
            n.app.da_warmer.wait_idle()
        require(len({n.app.last_app_hash for n in nodes}) == 1 and all(len(n.pool) == 0 for n in nodes),
                "the socket network's validators diverged or kept txs")
        return {"heights": out, "misses": {n.name: n.app.eds_cache.misses for n in nodes}}
    finally:
        for s in svcs:
            s.shutdown()
        for n in nodes:
            n.app.da_warmer.wait_idle()
            n.app.close()


def big_height_checks(nodes: list, entry, url: str, hk: int) -> dict:
    """The k = 128 height right after it commits: every validator's data
    root against the CPU path, then its samples and namespace reads over
    HTTP from the entry validator, off the entry the warmer seeded."""
    for n in nodes:
        n.app.da_warmer.wait_idle()
    blk = entry.app.db.load_block(hk)
    cpu_root = None
    for n in nodes:
        cached = n.app.eds_cache.lookup_root(blk.header.data_hash)
        require(cached is not None and cached.data_root == blk.header.data_hash,
                f"{n.name} holds no entry of height {hk}")
        if cpu_root is None:
            k = blk.header.square_size
            _, _, cpu_root = dah.new_dah_from_ods(cached.eds.squares[:k, :k], device="cpu")
        require(cpu_root == cached.data_root, f"{n.name}: the data root differs from the CPU path")
    builds0 = telemetry.snapshot()["counters"].get("das.square_builds", 0)
    present = sorted({b.namespace.raw for raw in blk.txs for btx in [blob.try_unmarshal_blob_tx(raw)]
                      if btx is not None for b in btx.blobs})
    served = serve_k128(url, entry.app, hk, present)
    served["square_builds"] = telemetry.snapshot()["counters"].get("das.square_builds", 0) - builds0
    require(served["square_builds"] == 0, f"serving the warm height built {served['square_builds']} squares")
    return served


def network_plane(dev: torch.device, honest_raws: list[bytes]) -> tuple[dict, dict]:
    """Four port ValidatorServices on the card, each with a ConsensusReactor
    gossiping over 127.0.0.1, commit the admission plane's 1,110 honest
    raws (POSTed to one validator, carried to the others by the CAT
    gossip); the k = 128 height is sampled and read over HTTP, one
    validator is down over the big heights and blocksyncs back, a fifth
    joins by chunked state sync, and a SocketNetwork drives four further
    services. Then, on the same live chain before its services shut
    down, the light plane (`light_plane`). Returns the launch counts of
    the two phases."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    reset_counts()
    home = tempfile.mkdtemp(prefix="chip-smoke-network-")
    privs = [crypto.PrivateKey.from_seed(b"chip-smoke-validator-%d" % i) for i in range(NODE_VALIDATORS)]
    gen = consensus_genesis(privs)
    rotation = sorted(k.public_key().address() for k in privs)
    by_addr = {k.public_key().address(): i for i, k in enumerate(privs)}
    entry_i = by_addr[rotation[5 % len(rotation)]]  # the proposer of the first height with the raws
    victim_i = by_addr[rotation[(5 + 3) % len(rotation)]]  # its slot comes last
    tally, gossip = LaunchTally(), GossipBytes()
    counters0 = telemetry.snapshot()["counters"]
    scalar0 = admission.counters["admission.sig_scalar_verified"]
    svcs, gates, nodes, extra = [None] * len(privs), [None] * len(privs), [None] * len(privs), []
    misses: dict = {}  # validator -> EDS cache misses of the Apps it closed
    tally.install()
    gossip.install()
    try:
        for i, k in enumerate(privs):
            # the entry validator keeps every proof pack (pack_keep=0)
            nodes[i] = network_validator(f"val{i}", k, gen, home, dev, pack_keep=0 if i == entry_i else None)
            tally.validator(nodes[i])
            svcs[i] = validator_server.ValidatorService(nodes[i])
            svcs[i].serve_background()
        urls = [f"http://127.0.0.1:{s.port}" for s in svcs]
        for i, s in enumerate(svcs):
            gates[i] = network_reactor(tally, s, [u for j, u in enumerate(urls) if j != i])
        heights: dict = {}
        for h in range(1, 5):  # every proposer seen once: the warm windows apply
            heights[h] = {"s": run_height(gates, h)}

        # the victim goes down; the raws go to the proposer of the next height
        victim_port = svcs[victim_i].port
        svcs[victim_i].shutdown()
        nodes[victim_i].app.da_warmer.wait_idle()
        misses[nodes[victim_i].name] = nodes[victim_i].app.eds_cache.misses
        nodes[victim_i].app.close()
        live = [i for i in range(len(privs)) if i != victim_i]
        entry, entry_url = nodes[entry_i], urls[entry_i]
        t0 = time.perf_counter()
        codes = [transport.request_json(entry_url, "/broadcast_tx", {"tx": base64.b64encode(raw).decode()},
                                        timeout=60)["code"] for raw in honest_raws]
        post_s = time.perf_counter() - t0
        require(codes.count(0) == len(honest_raws), f"/broadcast_tx refused {len(codes) - codes.count(0)} raws")
        # the CAT gossip: the others pull what the entry announced (the
        # first thing of each reactor step, run here before the heights,
        # again as long as announces are still arriving)
        t0 = time.perf_counter()

        def pull(i: int) -> None:
            deadline = time.monotonic() + NETWORK_WAIT_S
            while len(nodes[i].pool) < len(honest_raws) and time.monotonic() < deadline:
                gates[i].reactor._admit_pending_txs()
                time.sleep(0.01)

        pullers = [threading.Thread(target=pull, args=(i,)) for i in live if i != entry_i]
        for th in pullers:
            th.start()
        for th in pullers:
            th.join(NETWORK_WAIT_S)
        gossip_s = time.perf_counter() - t0
        pooled = {nodes[i].name: len(nodes[i].pool) for i in live}
        require(all(n == len(honest_raws) for n in pooled.values()), f"the CAT gossip left the pools at {pooled}")

        gates_live = [gates[i] for i in live]
        h, hk, served = 4, None, None
        while True:
            h += 1
            require(h <= 4 + CONSENSUS_MAX_HEIGHTS, "the mempools never drained")
            heights[h] = {"s": run_height(gates_live, h)}
            blk = entry.app.db.load_block(h)
            heights[h].update(k=blk.header.square_size, txs=len(blk.txs))
            if hk is None and blk.header.square_size == K_MAIN:
                hk = h
                served = big_height_checks([nodes[i] for i in live], entry, entry_url, hk)
            if not blk.txs and not any(len(nodes[i].pool) for i in live):
                break
        require(hk is not None, f"no height reached k = {K_MAIN}: {[(x, r.get('k')) for x, r in heights.items()]}")
        committed = sum(rec.get("txs", 0) for rec in heights.values())
        require(committed == len(honest_raws), f"{committed} of {len(honest_raws)} raws committed")

        # the victim restarts on its port (load, WAL replay), hears that its
        # peers are ahead, waits the reactor's sync grace and blocksyncs
        vnode = network_validator(f"val{victim_i}", privs[victim_i], gen, home, dev)
        tally.validator(vnode)
        with tally.tag(who=vnode.name):
            vnode.app.load()
            replayed = vnode.replay_wal()
        nodes[victim_i] = vnode
        behind = vnode.app.height
        svcs[victim_i], bind_retries = bind_again(lambda: validator_server.ValidatorService(vnode, port=victim_port))
        svcs[victim_i].serve_background()
        gates[victim_i] = network_reactor(tally, svcs[victim_i], [u for j, u in enumerate(urls) if j != victim_i])
        vr = svcs[victim_i].reactor
        synced: list = []
        orig_apply = vr._apply_pending_commit

        def timed_apply():
            h0, t0 = vnode.app.height, time.perf_counter()
            out = orig_apply()
            if vnode.app.height > h0:
                synced.append({"height": vnode.app.height, "s": time.perf_counter() - t0})
            return out

        vr._apply_pending_commit = timed_apply
        deadline = time.monotonic() + NETWORK_WAIT_S
        while not all(g.reactor.net.available(urls[victim_i]) for g in gates_live):
            require(time.monotonic() < deadline, "the peers' breakers never let the restarted validator in")
            time.sleep(0.05)
        vr._probe_peer_heights()  # the reactor's own pull-probe of its peers' heights
        require(vr._ahead is not None and vr._ahead[0] == h + 1, f"the restarted validator's probe: {vr._ahead}")
        grace = vr.cfg.sync_grace - (time.monotonic() - vr._ahead[2])
        if grace > 0:
            time.sleep(grace)
        t0 = time.perf_counter()
        run_height([gates[victim_i]], h)
        blocksync_s = time.perf_counter() - t0
        require(vnode.app.height == h and vr.blocksync_fetch_errors == 0,
                f"the restarted validator stopped at {vnode.app.height} of {h}")
        h += 1
        heights[h] = {"s": run_height(gates, h), "k": 1, "txs": 0}
        reactors = [s.reactor for s in svcs]
        for x in range(1, h + 1):
            seen = {r.app_hashes[x] for r in reactors if x in r.app_hashes}
            require(len(seen) <= 1, f"divergence at height {x}: {seen}")
        require(len({n.app.last_app_hash for n in nodes}) == 1, "the validators' app hashes differ")
        for x, rec in heights.items():
            rec["rounds"] = sorted({(r.commit_at(x) or {}).get("cert", {}).get("round", -1) for r in reactors})
            rec["gossip_bytes"] = gossip.sent.get(x, 0)

        # a fifth validator joins by chunked state sync, then blocksyncs the tail
        joiner = network_validator("joiner", crypto.PrivateKey.from_seed(b"chip-smoke-joiner"), gen, home, dev)
        tally.validator(joiner)
        extra.append(joiner)
        client = sync_mod.StateSyncClient(urls, os.path.join(home, "joiner", "statesync"), name="joiner",
                                          da_scheme=sync_mod.scheme_of(joiner))
        (manifest, chunks), statesync_s = timed(client.fetch)
        with tally.tag(who=joiner.name):
            consensus.state_sync_bootstrap(joiner, manifest, chunks)
        client.cleanup()
        require(joiner.app.last_app_hash.hex() == manifest["app_hash"]
                and reactors[entry_i].app_hashes.get(joiner.app.height) == manifest["app_hash"],
                "the joiner's snapshot app hash is not the network's")
        jr = reactor_mod.ConsensusReactor(joiner, urls, threading.Lock(), reactor_mod.ReactorConfig())
        t0 = time.perf_counter()
        with tally.tag(who=joiner.name):
            while joiner.app.height < h:
                require(jr._blocksync_step(h, entry_url), f"the joiner's blocksync stopped at {joiner.app.height}")
        joiner_tail_s = time.perf_counter() - t0
        jr.stop()
        joiner.app.da_warmer.wait_idle()
        require(joiner.app.last_app_hash == entry.app.last_app_hash, "the joiner's app hash differs")

        for g in gates:
            g.reactor.stop()
        for n in nodes:
            n.app.da_warmer.wait_idle()
        sock = socket_network_heights(dev, gen, privs, os.path.join(home, "socket"), tally)

        # launches: each validator's against the squares and provers it built
        torch.cuda.synchronize()
        counts = read_counts()
        for n in nodes + extra:
            misses[n.name] = misses.get(n.name, 0) + n.app.eds_cache.misses
        misses.update(sock["misses"])
        by_validator = {}
        for name in misses:
            got, want, squares = tally.of(name), tally.expected(name), tally.entries.get(name, [])
            square_k1 = sum(got.get(src, {}).get("sha256_compress", 0) for src in ("entry", "levels"))
            square_k2 = sum(src.get("rs_extend_lines", 0) for src in got.values())
            by_validator[name] = {"launches": got, "expected": want, "squares": squares,
                                  "cache_misses": misses[name], "provers": len(tally.provers.get(name, []))}
            require(len(squares) == misses[name], f"{name}: {len(squares)} squares for {misses[name]} cache misses")
            require(square_k1 == want["sha256_compress"] and square_k2 == want["rs_extend_lines"],
                    f"{name}: launches {got} do not match its squares {squares} and provers "
                    f"{tally.provers.get(name, [])}")
            require("None" not in got, f"{name} launched outside a square, a prover or a commitment: {got}")
        stray = {str(k): v for k, v in tally.counts.items() if k[0] not in misses}
        require(not stray, f"launches on no validator's thread: {stray}")
        total = {kernel: sum(v[kernel] for v in tally.counts.values()) for kernel in LaunchTally.KERNELS}
        require(total == counts, f"the tally {total} is not the wrappers' count {counts}")
        for n in nodes + extra:
            require(n.app.last_reject is None, f"{n.name}: ProcessProposal rejected: {n.app.last_reject}")
        for r in reactors:
            require(r.loop_errors == 0 and r.statesync_errors == 0, f"{r.vnode.name}: reactor errors")
        tel = telemetry.snapshot()["counters"]
        moved = {name: tel.get(name, 0) - counters0.get(name, 0) for name in NETWORK_ZERO
                 if tel.get(name, 0) != counters0.get(name, 0)}
        rejects = {k: v - counters0.get(k, 0) for k, v in tel.items()
                   if k.startswith("process_proposal.rejects") and v != counters0.get(k, 0)}
        require(not moved and not rejects, f"counters moved: {moved} {rejects}")
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        emit("network_plane", validators=len(privs), entry=entry.name, victim=vnode.name,
             heights=heights, k128_height=hk, post_s=post_s, gossip_pull_s=gossip_s, pooled=pooled,
             gossip_pulled_bytes=gossip.pulled, gossip_tx_bytes=gossip.sent.get("tx", 0),
             mempool_gossip={r.vnode.name: dict(r.mempool_gossip.stats) for r in reactors},
             restart={"from_height": behind, "wal_replayed": replayed, "blocksync_s": blocksync_s,
                      "per_height": synced, "bind_retries": bind_retries},
             state_sync={"height": manifest["height"], "chunks": manifest["n_chunks"], "s": statesync_s,
                         "fetched": client.stats["fetched"], "tail_heights": h - manifest["height"],
                         "tail_s": joiner_tail_s},
             serving=served, socket_network=sock["heights"], launches=counts, by_validator=by_validator,
             sig_scalar_verified=admission.counters["admission.sig_scalar_verified"] - scalar0,
             app_hash=entry.app.last_app_hash.hex(), peak_mib_above_base=peak_mib - base_mib,
             base_mib=base_mib, phase_s=time.perf_counter() - t_phase)
        light = light_plane(dev, {"tally": tally, "gossip": gossip, "svcs": svcs, "nodes": nodes, "urls": urls,
                                  "entry_i": entry_i, "privs": privs, "gen": gen, "rotation": rotation, "hk": hk, "home": home})
        return counts, light
    finally:
        gossip.remove()
        tally.remove()
        for s in svcs:
            if s is not None:
                with contextlib.suppress(Exception):  # a service already shut down
                    s.shutdown()
        for n in nodes + extra:
            if n is not None:
                n.app.da_warmer.wait_idle()
                with contextlib.suppress(Exception):  # the victim's first App is closed already
                    n.app.close()
        shutil.rmtree(home, ignore_errors=True)


LIGHT_DASERS = 4
LIGHT_PFBS = 8
LIGHT_BLOB_BYTES = 2_000
LIGHT_ZERO = ("http.500", "light.malformed_fraud_proofs", "daser.befp_failed", "daser.pack_chunk_rejected",
              "follower.verify_failures", "reactor.prewarm_errors", "packs.build_errors", "blobpacks.build_errors",
              "consensus.propose_errors", "edscache.warm_errors", "txclient.sim_fallback")


def counts_since(before: dict) -> dict:
    now = read_counts()
    return {name: now[name] - before[name] for name in now}


def tally_since(tally: LaunchTally, before: dict) -> dict:
    """{"who/what": launches} of the tally since `before`."""
    out = {}
    with tally.lock:
        now = {key: dict(v) for key, v in tally.counts.items()}
    for key, row in now.items():
        was = before.get(key, {})
        diff = {name: row[name] - was.get(name, 0) for name in row if row[name] != was.get(name, 0)}
        if diff:
            out[f"{key[0]}/{key[1]}"] = diff
    return out


def light_trust(gen: dict) -> light_mod.TrustedState:
    """The genesis trust of a light node: the validators and powers of
    `gen` (pubkeys in genesis)."""
    return light_mod.TrustedState(
        height=0, header_hash=b"",
        validators={bytes.fromhex(v["operator"]): bytes.fromhex(v["pubkey"]) for v in gen["validators"]},
        powers={bytes.fromhex(v["operator"]): int(v["power"]) for v in gen["validators"]})


def window_draws(seed: int, widths: dict, cfg) -> dict:
    """The cells a fresh DASer seeded `seed` draws per height when its
    sweep runs as a continuation (job i on rng lane i % lanes): the
    pending heights in jobs of cfg.job_size, each job's heights drawn in
    order from its lane."""
    heights = sorted(widths)
    jobs = [heights[i:i + cfg.job_size] for i in range(0, len(heights), cfg.job_size)]
    lanes = np.random.default_rng(seed).spawn(min(cfg.workers, len(heights)))
    out = {}
    for j, job in enumerate(jobs):
        rng = lanes[j % len(lanes)]
        for h in job:
            w = widths[h]
            out[h] = {(int(rng.integers(0, w)), int(rng.integers(0, w))) for _ in range(cfg.samples_per_header)}
    return out


def hitting_seed(widths: dict, height: int, withheld: set, cfg, start: int) -> int:
    """The first seed from `start` whose draws at `height` hit `withheld`."""
    for seed in range(start, start + 20_000):
        if window_draws(seed, widths, cfg)[height] & withheld:
            return seed
    raise RuntimeError(f"no DASer seed in [{start}, {start + 20_000}) hits the withheld cells of {height}")


def sweep(d) -> dict:
    """One sweep of `d` as a continuation (deterministic rng lanes)."""
    cont = d.begin_sweep()
    while cont.step():
        pass
    return cont.summary


def repair_timer_s() -> float:
    """Seconds in the DASers' repairs so far (the `daser.repair` timer)."""
    return telemetry.snapshot()["timers"].get("daser.repair", {}).get("total_s", 0.0)


def counter(name: str) -> int:
    return telemetry.snapshot()["counters"].get(name, 0)


def escalation_split(d, height: int, repair_s: float) -> dict:
    """The split of `d`'s escalation of `height`, read off its own trace
    table: the cell fetches (its `das.fetch_cells` spans, by axis: the
    whole-square batches are "row", a BEFP's orthogonal proofs "col"),
    the repair (`repair_s`, the `daser.repair` timer; its `da.repair.*`
    spans), and the rest of the height's `das.sample_height` span, which
    is the host verify of the fetched cells, the square's assembly and
    the draws before the escalation."""
    spans = [r for r in d.traces.read("spans", limit=telemetry.TraceTables.MAX_ROWS) if r.get("height") == height
             or r["name"].startswith("da.repair.")]
    fetch = {}
    for r in spans:
        if r["name"] == "das.fetch_cells":
            row = fetch.setdefault(r["axis"], {"requests": 0, "cells": 0, "s": 0.0})
            row["requests"] += 1
            row["cells"] += r["cells"]
            row["s"] += r["dur_ms"] / 1e3
    height_s = sum(r["dur_ms"] for r in spans if r["name"] == "das.sample_height") / 1e3
    fetch_s = sum(row["s"] for row in fetch.values())
    return {"sample_height_s": height_s, "fetch": fetch, "repair_s": repair_s,
            "repair_spans_s": {name: sum(r["dur_ms"] for r in spans if r["name"] == name) / 1e3
                               for name in ("da.repair.sweep", "da.repair.verify_roots")},
            "verify_and_rest_s": height_s - fetch_s - repair_s}

def blobs_of(block, ns: bytes) -> list[bytes]:
    """The blobs of `block`'s PFBs in namespace `ns`, sorted."""
    return sorted(b.data for raw in block.txs for btx in [blob.try_unmarshal_blob_tx(raw)]
                  if btx is not None for b in btx.blobs if b.namespace.raw == ns)


def light_plane(dev: torch.device, ctx: dict) -> dict:
    """The light side of the network on the network plane's live chain:
    a port NodeService beside the entry validator's ValidatorService (as
    `validator-serve --http` puts one), four DASers on the card sampling
    every height over HTTP, a withheld but repairable k = 128 height
    recovered on the card, a certified k = 128 non-codeword halted by a
    BEFP verified on the card, two blob followers, 8 PFBs written through
    TxClient over HttpNodeClient and committed by the reactors, and the DA
    shim. Returns the launch counts of the phase."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    tally, svcs, nodes, urls = ctx["tally"], ctx["svcs"], ctx["nodes"], ctx["urls"]
    entry_i, privs, gen, hk, rotation = ctx["entry_i"], ctx["privs"], ctx["gen"], ctx["hk"], ctx["rotation"]
    entry = nodes[entry_i]
    home = os.path.join(ctx["home"], "light")
    counters0 = telemetry.snapshot()["counters"]
    reset_counts()
    tally0 = {key: dict(v) for key, v in tally.counts.items()}
    wire, undo, gates, node_svc = ctx["gossip"], [], [None] * len(svcs), None
    steps: dict = {}

    spent = {"repair": 0.0, "befp": 0.0, "shim": 0.0}  # seconds inside each tagged function (the BEFP's read)

    def tagged(owner, name: str, what: str) -> None:
        orig = getattr(owner, name)

        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                with tally.tag(what=what):
                    return orig(*a, **kw)
            finally:
                spent[what] += time.perf_counter() - t0

        setattr(owner, name, run)
        undo.append((owner, name, orig))

    tagged(repair, "repair_eds", "repair")
    tagged(fraud, "verify_befp", "befp")
    tagged(da_service.DACore, "_pipeline", "shim")
    # TxClient's transport speaks http.client, not urllib: meter its JSON bodies here
    orig_request = tx_client.HttpNodeClient._request

    def metered(client, method, path, payload=None):
        out = orig_request(client, method, path, payload)
        wire.add(path, len(json.dumps(payload)) if payload is not None else 0, len(json.dumps(out)))
        return out

    tx_client.HttpNodeClient._request = metered
    undo.append((tx_client.HttpNodeClient, "_request", orig_request))

    def begin() -> tuple:
        torch.cuda.synchronize()
        return time.perf_counter(), read_counts(), wire.snapshot(), {k: dict(v) for k, v in tally.counts.items()}

    def end(name: str, mark: tuple, **extra) -> dict:
        torch.cuda.synchronize()
        t0, c0, w0, k0 = mark
        rec = {"s": time.perf_counter() - t0, "launches": counts_since(c0), "by_source": tally_since(tally, k0),
               "wire": wire.since(w0), **extra}
        steps[name] = rec
        return rec

    def new_daser(name: str, store: str, seed: int | None = None, **kw):
        return daser_mod.DASer([url], light_mod.LightClient(CONSENSUS_CHAIN, light_trust(gen)),
                               checkpoint_mod.CheckpointStore(os.path.join(home, store, "checkpoint.json")),
                               rng=np.random.default_rng(seed), name=name, device=dev, **kw)

    def new_follower(name: str, ns: bytes):
        return follower_mod.BlobFollower([url], ns, light_mod.LightClient(CONSENSUS_CHAIN, light_trust(gen)),
                                         checkpoint_mod.CheckpointStore(os.path.join(home, name, "follower.json")),
                                         name=name)

    try:
        node_svc = node_server.NodeService(entry, port=0)
        node_svc.lock = svcs[entry_i].lock  # one writer lock for the process, as validator-serve --http shares it
        node_svc.das_core.app_lock = svcs[entry_i].lock
        node_svc.serve_background()
        url = f"http://127.0.0.1:{node_svc.port}"
        for i, s in enumerate(svcs):
            gates[i] = network_reactor(tally, s, [u for j, u in enumerate(urls) if j != i])
        tip = entry.app.height
        blk_k = entry.app.db.load_block(hk)
        k = blk_k.header.square_size
        two_k = 2 * k

        # 1. the DA shim: the k = 128 ODS through /da/extend_commit, twice, and a PFB's share range
        _, sq = query.rebuild_square(entry.app, hk)
        ods_b64 = base64.b64encode(b"".join(sq.share_bytes())).decode()
        for run in ("cold", "warm"):
            mark = begin()
            out = transport.request_json(url, "/da/extend_commit", {"ods": ods_b64}, timeout=120)
            rec = end(f"shim_{run}", mark)
            require(out["data_root"] == blk_k.header.data_hash.hex() and out["square_size"] == k,
                    f"/da/extend_commit ({run}) is not the committed data root")
        require(steps["shim_cold"]["launches"] == entry_launches(k, 0),
                f"/da/extend_commit cold launches {steps['shim_cold']['launches']} != {entry_launches(k, 0)}")
        require(steps["shim_warm"]["launches"] == {"sha256_compress": 0, "rs_extend_lines": 0},
                f"/da/extend_commit warm launched {steps['shim_warm']['launches']}")
        start, stop = proof.blob_share_range(sq, 0, 0)
        mark = begin()
        doc = transport.request_json(url, "/da/prove_shares", {"data_root": out["data_root"], "start": start,
                                                               "end": stop}, timeout=60)
        end("shim_prove", mark, shares=stop - start)
        require(query.share_proof_from_json(doc["proof"]).verify(blk_k.header.data_hash),
                "/da/prove_shares does not verify against the data root")

        # 2. the sampling fleet: every height, then a restart that samples nothing
        conf = sampling.withholding_catch_confidence(daser_mod.DASerConfig().samples_per_header)
        fleet = [new_daser(f"light{i}", f"light{i}", SEED + 200 + i) for i in range(LIGHT_DASERS)]
        mark = begin()
        sweeps = []
        for d in fleet:
            t0 = time.perf_counter()
            got = d.sync()
            sweeps.append(time.perf_counter() - t0)
            require(got["halted"] is None and got["sampled"] == list(range(1, tip + 1)), f"{d.name}: {got}")
            bad = {h: r for h, r in d.reports.items() if r["status"] != "sampled" or r["confidence"] != conf}
            require(not bad, f"{d.name} reports {bad}")
        rec = end("sampling", mark, heights=tip, sweep_s=sweeps)
        require(rec["launches"] == {"sha256_compress": 0, "rs_extend_lines": 0},
                f"sampling launched on the card: {rec['by_source']}")
        served = {h: node_svc.das_core.availability(h) for h in range(1, tip + 1)}
        mark = begin()
        again = new_daser("light0-restarted", "light0")
        got = again.sync()
        end("sampling_restart", mark)
        require(got["sampled"] == [] and got["sample_from"] == tip + 1, f"the restarted DASer sampled {got}")
        require({h: node_svc.das_core.availability(h) for h in served} == served,
                "the restarted DASer moved the serving records")

        # 3. followers: a PFB namespace of the k = 128 height, and an absent one
        present = sorted({b.namespace.raw for raw in blk_k.txs for btx in [blob.try_unmarshal_blob_tx(raw)]
                          if btx is not None for b in btx.blobs})
        ns_follow = present[0]
        absent = next(ns[:-1] + bytes([ns[-1] + 1]) for ns in present
                      if ns[-1] < 255 and ns[:-1] + bytes([ns[-1] + 1]) not in present)
        want = {h: got_h for h in range(1, tip + 1) if (got_h := blobs_of(entry.app.db.load_block(h), ns_follow))}
        fol, fol_absent = new_follower("follower", ns_follow), new_follower("follower-absent", absent)
        tel = telemetry.snapshot()["counters"]
        mark = begin()
        got = fol.sync()
        got_absent = fol_absent.sync()
        rec = end("following", mark)
        # blobs_from_shares (as the reference's) turns each namespace
        # padding share of the run into an empty payload: compare the others
        popped = fol.pop_blobs()
        delivered = {h: sorted(p for p in v if p) for h, v in popped.items()}
        padding = sum(1 for v in popped.values() for p in v if not p)
        require(got == {"head": tip, "next_height": tip + 1, "verified": tip} and delivered == want,
                f"the follower read {got}; blobs at {sorted(delivered)} vs {sorted(want)}")
        require(got_absent["verified"] == tip and fol_absent.pop_blobs() == {}, f"absent namespace: {got_absent}")
        moved = {name: telemetry.snapshot()["counters"].get(name, 0) - tel.get(name, 0)
                 for name in ("follower.pack_reads", "follower.live_reads", "follower.absences")}
        require(moved["follower.absences"] >= tip, f"verified absences {moved}")
        require(rec["launches"] == {"sha256_compress": 0, "rs_extend_lines": 0},
                f"following launched on the card: {rec['by_source']}")
        steps["following"].update(reads=moved, blobs_at_k128=len(want.get(hk, [])), padding_payloads=padding)
        tel = telemetry.snapshot()["counters"]
        mark = begin()
        restarted = new_follower("follower", ns_follow)
        restarted.catch_up_roots()
        got = restarted.sync()
        end("following_restart", mark)
        require(got["verified"] == 0 and restarted.next_height == tip + 1
                and telemetry.snapshot()["counters"].get("follower.heights", 0) == tel.get("follower.heights", 0),
                f"the restarted follower re-read {got}")

        # 4. a withheld but repairable k = 128 height: a quarter of the rows withheld. Packs serve every
        # cell (a withholder publishes none), so this DASer reads live cells only and its repair rebuilds
        # the withheld rows on the card
        cfg = daser_mod.DASerConfig(prefer_packs=False)
        withheld = {(r, c) for r in range(k // 2) for c in range(two_k)}
        node_svc.das_core.withhold(hk, withheld)
        widths = {h: 2 * entry.app.db.load_block(h).header.square_size for h in range(1, tip + 1)}
        seed = hitting_seed(widths, hk, withheld, cfg, SEED + 300)
        catcher = new_daser("light-withheld", "light-withheld", seed, cfg=cfg)
        repair0, pack0 = repair_timer_s(), counter("daser.pack_samples")
        mark = begin()
        got = sweep(catcher)
        rec = end("withheld", mark, packs=counter("daser.pack_samples") - pack0)
        rep = catcher.reports[hk]
        require(got["halted"] is None and rep["status"] == "recovered", f"the withheld height: {rep}")
        split = escalation_split(catcher, hk, repair_timer_s() - repair0)
        require(split["fetch"].get("row", {}).get("cells", 0) >= two_k * two_k and not rec["packs"],
                f"the withheld escalation fetched {split['fetch']} live and {rec['packs']} pack cells")
        present = np.ones((two_k, two_k), dtype=bool)
        present[: k // 2] = False
        repair_launches = rec["by_source"].get("None/repair", {})
        want_repair = sweep_launches(present)
        require(repair_launches == want_repair, f"the withheld repair launched {rec['by_source']}, want {want_repair}")
        rec.update(seed=seed, withheld_cells=len(withheld), failed_samples=len(rep["failed"]), split=split)

        # 5. writes over HTTP: 8 PFBs through TxClient, committed by the reactors at the entry's next slot
        h = tip
        empties = []
        while rotation[(h + 1) % len(rotation)] != entry.address:
            h += 1
            empties.append(run_height(gates, h))
        rng = np.random.default_rng(SEED + 400)
        datas = [rng.integers(0, 256, LIGHT_BLOB_BYTES, dtype=np.uint8).tobytes() for _ in range(LIGHT_PFBS)]
        confirms: list = [None] * LIGHT_PFBS
        errors: list = []

        def submit(i: int) -> None:
            try:
                priv = crypto.PrivateKey.from_seed(b"chip-smoke-account-%d" % i)
                a = priv.public_key().address()
                acc = transport.request_json(url, "/abci_query", {"path": "auth/account",
                                                                  "data": {"address": a.hex()}})["account"]
                signer = tx_client.Signer(CONSENSUS_CHAIN)
                signer.add_account(priv, number=acc["number"], sequence=acc["sequence"])
                remote = tx_client.HttpNodeClient(url)
                try:
                    confirms[i] = tx_client.TxClient(remote, signer).submit_pay_for_blob(
                        a, [blob.Blob(namespace.Namespace(ns_follow), datas[i])])
                finally:
                    remote.close()
            except Exception as e:  # reported below; the phase fails on it
                errors.append(f"PFB {i}: {type(e).__name__}: {e}")

        simulated = []  # the codes of the entry's simulations: each PFB's gas comes from one
        orig_simulate = entry.app.simulate_tx

        def simulate(raw):
            res = orig_simulate(raw)
            simulated.append(res.code)
            return res

        entry.app.simulate_tx = simulate
        undo.append((entry.app, "simulate_tx", orig_simulate))
        mark = begin()
        writers = [threading.Thread(target=submit, args=(i,)) for i in range(LIGHT_PFBS)]
        for th in writers:
            th.start()
        deadline = time.monotonic() + NETWORK_WAIT_S
        while len(entry.pool) < LIGHT_PFBS and not errors:
            require(time.monotonic() < deadline, f"the entry validator's pool holds {len(entry.pool)} PFBs")
            time.sleep(0.01)
        t_admitted = time.perf_counter() - mark[0]
        hw = h + 1
        height_s = run_height(gates, hw)
        for th in writers:
            th.join(NETWORK_WAIT_S)
        rec = end("writes", mark, admitted_s=t_admitted, height_s=height_s, empty_heights_s=empties, height=hw)
        require(not errors, f"TxClient: {errors}")
        require(simulated == [0] * LIGHT_PFBS and rec["wire"].get("/simulate_tx", [0])[0] == LIGHT_PFBS,
                f"gas estimation: simulations {simulated}, /simulate_tx {rec['wire'].get('/simulate_tx')}")
        require(all(c is not None and c.get("found") and c.get("height") == hw for c in confirms),
                f"the PFBs were not confirmed at height {hw}: {confirms} (pool {len(entry.pool)}, "
                f"{len(entry.app.db.load_block(hw).txs)} txs at {hw} by {entry.app.db.load_block(hw).header.proposer.hex()[:8]}, "
                f"entry {entry.address.hex()[:8]}, {time.perf_counter() - mark[0]:.1f} s)")
        blk_w = entry.app.db.load_block(hw)
        require(blobs_of(blk_w, ns_follow) == sorted(datas), "the committed height does not carry the 8 blobs")
        rounds = {(s.reactor.commit_at(hw) or {}).get("cert", {}).get("round") for s in svcs}
        require(rounds == {0}, f"height {hw} committed in rounds {rounds}")
        rec.update(k=blk_w.header.square_size, tx_bytes=sum(len(raw) for raw in blk_w.txs))
        for n in nodes:
            n.app.da_warmer.wait_idle()
        mark = begin()
        got = fol.sync()
        popped = fol.pop_blobs()
        delivered = {h: [p for p in v if p] for h, v in popped.items()}
        for d in fleet:
            caught = d.sync()
            require(caught["halted"] is None and caught["sample_from"] == hw + 1, f"{d.name} after the writes: {caught}")
        rec = end("read_back", mark, padding_payloads=sum(1 for v in popped.values() for p in v if not p))
        require(got["next_height"] == hw + 1 and sorted(delivered.get(hw, [])) == sorted(datas)
                and set(delivered) == {hw}, f"the follower read back {got}, blobs at {sorted(delivered)}")
        require(rec["launches"] == {"sha256_compress": 0, "rs_extend_lines": 0},
                f"reading back launched on the card: {rec['by_source']}")

        # 6. fraud: a certified k = 128 non-codeword past the tip, half its bad row withheld
        tip2 = entry.app.height
        bad_h = tip2 + 1
        bad_row = int(np.random.default_rng(SEED + 500).integers(0, two_k))
        corrupt = entry.app.eds_cache.lookup_root(blk_k.header.data_hash).eds.squares.copy()
        corrupt[bad_row, two_k - 1] ^= 0x5A
        mark = begin()
        with tally.tag(what="fixture"):
            rows_bad = nmt.eds_axis_roots(corrupt, list(range(two_k)), k)
            cols_bad = nmt.eds_axis_roots(np.swapaxes(corrupt, 0, 1), list(range(two_k)), k)
        end("fraud_fixture", mark)
        d_bad = dah.DataAvailabilityHeader(row_roots=tuple(r.tobytes() for r in rows_bad),
                                           col_roots=tuple(c.tobytes() for c in cols_bad))
        node_svc.das_core.seed_entry(bad_h, dah.ExtendedDataSquare(corrupt), d_bad)
        withheld_bad = {(bad_row, j) for j in range(k)}
        node_svc.das_core.withhold(bad_h, withheld_bad)
        header = block_mod.Header(
            chain_id=CONSENSUS_CHAIN, height=bad_h, time_unix=entry.app.db.load_block(tip2).header.time_unix + 1,
            data_hash=d_bad.hash(), square_size=k, app_hash=b"\x77" * 32, proposer=entry.address,
            app_version=entry.app.app_version, last_block_hash=entry.app.last_block_hash,
            validators_hash=block_mod.validators_hash_of([(p.public_key().address(), 10) for p in privs]))
        votes = tuple(consensus.Vote(bad_h, header.hash(), p.public_key().address(),
                                     p.sign(consensus.Vote.sign_bytes(CONSENSUS_CHAIN, bad_h, header.hash(),
                                                                      "precommit", 0)), "precommit", 0)
                      for p in privs)
        cert = consensus.CommitCertificate(bad_h, header.hash(), votes, 0)
        peers = daser_mod.PeerSet([url])
        base_source = daser_mod.http_header_source(peers)
        os.makedirs(os.path.join(home, "hunter"), exist_ok=True)
        shutil.copy(fleet[0].store.path, os.path.join(home, "hunter", "checkpoint.json"))
        seed = hitting_seed({bad_h: two_k}, bad_h, withheld_bad, cfg, SEED + 600)
        hunter = new_daser("light-hunter", "hunter", seed,
                           header_source=lambda x: (header, cert) if x == bad_h else base_source(x))
        repair0, befp0 = repair_timer_s(), spent["befp"]
        mark = begin()
        got = hunter.sync()
        rec = end("fraud", mark, seed=seed)
        rep = hunter.reports.get(bad_h, {})
        require(got["halted"] == {"height": bad_h, "reason": "bad-encoding", "data_root": d_bad.hash().hex()}
                and rep.get("status") == "fraud" and (rep.get("axis"), rep.get("index")) == ("row", bad_row),
                f"the hunter: {got} {rep}")
        require(hunter.light.condemned_roots == {d_bad.hash()}, "the BEFP did not condemn the root")
        befp_launches = rec["by_source"].get("None/befp", {})
        want_befp = {"sha256_compress": 1 + int(math.log2(two_k)), "rs_extend_lines": 2}
        require(befp_launches == want_befp, f"the BEFP check launched {rec['by_source']}, want {want_befp}")
        rec.update(split=escalation_split(hunter, bad_h, repair_timer_s() - repair0), befp_s=spent["befp"] - befp0,
                   failed_samples=len(rep.get("failed", [])))
        reborn = new_daser("light-hunter-reborn", "hunter")
        require(reborn.halted and reborn.sync() == {"halted": got["halted"]}, "the reborn hunter followed on")
        for d in fleet[1:]:
            require(not d.sync()["halted"], f"{d.name} halted")

        for g in gates:
            g.reactor.stop()
        for n in nodes:
            n.app.da_warmer.wait_idle()
        torch.cuda.synchronize()
        counts = read_counts()
        by_source = tally_since(tally, tally0)
        require("None/None" not in by_source, f"launches of no known source: {by_source}")
        total = {name: sum(v.get(name, 0) for v in by_source.values()) for name in LaunchTally.KERNELS}
        require(total == counts, f"the tally {total} is not the wrappers' count {counts}")
        for g in gates:
            require(g.reactor.loop_errors == 0, f"{g.reactor.vnode.name}: reactor loop errors")
        for n in nodes:
            require(n.app.last_reject is None, f"{n.name}: ProcessProposal rejected: {n.app.last_reject}")
        tel = telemetry.snapshot()["counters"]
        moved = {name: tel.get(name, 0) - counters0.get(name, 0) for name in LIGHT_ZERO
                 if tel.get(name, 0) != counters0.get(name, 0)}
        rejects = {key: v - counters0.get(key, 0) for key, v in tel.items()
                   if key.startswith("process_proposal.rejects") and v != counters0.get(key, 0)}
        require(not moved and not rejects, f"counters moved: {moved} {rejects}")
        dasers = {name: tel.get(name, 0) - counters0.get(name, 0) for name in (
            "daser.requests", "daser.sampling_round_trips", "daser.pack_samples", "daser.escalations",
            "daser.recovered", "daser.befp_verified", "daser.halts", "daser.headers_sampled",
            "follower.heights", "follower.blobs", "follower.pack_reads", "follower.live_reads",
            "das.square_builds", "das.pack_hits", "das.live_assembled", "txclient.reconnects")}
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        emit("light_plane", node_service=url, entry=entry.name, tip=tip, k128_height=hk, steps=steps,
             counters=dasers, launches=counts, by_source=by_source, peak_mib_above_base=peak_mib - base_mib,
             base_mib=base_mib, phase_s=time.perf_counter() - t_phase)
        return counts
    finally:
        for owner, name, orig in reversed(undo):
            setattr(owner, name, orig)
        for g in gates:
            if g is not None:
                g.reactor.stop()
        if node_svc is not None:
            node_svc.shutdown()


# -- phase: the scenario plane (sim/*) on the card -------------------------------

SCENARIO_SEED = 0
SCENARIO_SCHEMES = ("rs2d-nmt", "cmt-ldpc", "pcmt-polar")  # every registered wire id, as bench.py --scenario
SCENARIO_MATRIX = ("honest", "withhold-threshold", "incorrect-coding", "partition-churn")  # bench.py:2907-2990
SCENARIO_TWINS = ("honest", "incorrect-coding")  # rs2d-nmt cells run again on the CPU: equal verdict bytes
SCENARIO_ZERO = ("http.500", "daser.befp_failed", "daser.pack_chunk_rejected", "edscache.warm_errors",
                 "consensus.propose_errors")
# one traffic op of the grammar as it is: txsim's shape at sizes that fill
# the square to the default gov_max_square_size (k = 64)
SCENARIO_TRAFFIC = {"op": "traffic", "sequences": 8, "pfbs_per_wave": 1, "blobs_per_pfb": [1, 3],
                    "blob_sizes": [100_000, 250_000], "every": 0.9}
TRAFFIC_K = 64
TRAFFIC_MIN_FULL_HEIGHTS = 3
FLEET_HEIGHTS = 12  # fleet-scale's 1,000 heights, cut so that its two runs take about 30 s


class ScenarioTally:
    """K1 / K2 launches of the scenario plane by (node, height, source).

    A simulation runs one scheduler event at a time on the calling thread,
    and a validator waits for its prover warmer inside the event that
    committed (sim/engine.SimValidator._apply), so one process-wide
    context, not a thread-local one, names the node and height of every
    launch, the warmer's included. Each scheduler event sets the node (its
    label's prefix, or the SimValidator of a bound method) and the height
    that node works on (a validator's next height, else the chain's); the
    serving route, the malicious fixture, a light node's escalation and its
    fraud-proof check set the source. A launch with no source set is the
    node's own work: a validator's squares, provers and commitments."""

    SOURCES = ("validators", "serving", "fixtures", "repairs", "fraud_proofs")

    def __init__(self):
        self.ctx = {"who": "setup", "height": 0, "source": None, "event": 0}
        self.counts: dict = {}  # (who, height, source) -> {kernel: launches}
        self.sim = None
        self.by_name: dict = {}
        self.heights: dict = {}  # height -> what its first commit showed
        self.waves: dict = {}  # height -> txs an op event submitted to its first validator, and accepted
        self.events = self.last_wave = 0
        self.undo: list = []

    def reset(self) -> None:
        self.counts, self.sim, self.by_name, self.heights, self.waves = {}, None, {}, {}, {}

    def _count(self, kernel: str) -> None:
        key = (self.ctx["who"], self.ctx["height"], self.ctx["source"] or "validators")
        self.counts.setdefault(key, dict.fromkeys(LaunchTally.KERNELS, 0))[kernel] += 1

    @contextlib.contextmanager
    def _set(self, **kw):
        old = dict(self.ctx)
        self.ctx.update(kw)
        try:
            yield
        finally:
            self.ctx = old

    def _height(self, who: str) -> int:
        v = self.by_name.get(who)
        if v is not None:
            return v.vnode.app.height + 1
        return max(self.sim.commit_times, default=0) + 1 if self.sim is not None else 0

    def _on_commit(self, sim, _val, height: int, block) -> None:
        self.heights[height] = {
            "k": block.header.square_size, "t": time.perf_counter(), "txs": len(block.txs),
            "pfbs": sum(1 for raw in block.txs if blob.try_unmarshal_blob_tx(raw) is not None)}

    def _patch(self, owner, name: str, make) -> None:
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self.undo.append((owner, name, orig))

    def install(self) -> None:
        tally = self

        def kernel(name, tensor_of):
            def make(orig):
                return TalliedKernel(orig, lambda *a, **kw: tally._count(name)
                                     if LaunchTally.on_card(tensor_of(*a, **kw)) else None)
            return make

        def sourced(source):
            def make(orig):
                def run(*a, **kw):
                    with tally._set(source=source):
                        return orig(*a, **kw)
                return run
            return make

        def call_at(orig):
            def schedule(sched, t, fn, label=""):
                who = label.split(".", 1)[0] if label else getattr(getattr(fn, "__self__", None), "name", "")

                def event():
                    tally.events += 1
                    with tally._set(who=who, height=tally._height(who), source=None, event=tally.events):
                        fn()
                return orig(sched, t, event, label)
            return schedule

        def admitted(orig):
            def run(vnode, *a, **kw):
                with tally._set(who=vnode.name):
                    return orig(vnode, *a, **kw)
            return run

        def wave(orig):
            # an op event's first batch goes to the validator whose
            # verdicts the traffic lanes follow (sim/scenarios.py)
            def run(vnode, raws, *a, **kw):
                out = admitted(orig)(vnode, raws, *a, **kw)
                if tally.ctx["who"] == "op" and tally.ctx["event"] != tally.last_wave:
                    tally.last_wave = tally.ctx["event"]
                    row = tally.waves.setdefault(tally.ctx["height"], {"submitted": 0, "accepted": 0})
                    row["submitted"] += len(raws)
                    row["accepted"] += sum(1 for r in out if r.code == 0)
                return out
            return run

        def attach(orig):
            def run(sim):
                tally.sim = sim
                tally.by_name = {v.name: v for v in sim.validators}
                sim.commit_listeners.append(tally._on_commit)
                return orig(sim)
            return run

        self._patch(sha256_kernel, "compress_words", kernel("sha256_compress", lambda blocks: blocks))
        self._patch(rs_kernel, "extend_lines", kernel("rs_extend_lines", lambda groups, operand: operand))
        self._patch(sim_scheduler.Scheduler, "call_at", call_at)
        self._patch(sim_engine.Simulation, "run", attach)
        self._patch(sim_engine.SimValidator, "route", sourced("serving"))
        self._patch(consensus.ValidatorNode, "add_txs", wave)
        self._patch(consensus.ValidatorNode, "add_tx", admitted)
        self._patch(malicious, "incorrect_coding_fixture", sourced("fixtures"))
        self._patch(daser_mod.DASer, "_escalate", sourced("repairs"))
        self._patch(daser_mod.DASer, "_escalate_codec", sourced("repairs"))
        self._patch(light_mod.LightClient, "submit_fraud_proof", sourced("fraud_proofs"))

    def remove(self) -> None:
        while self.undo:
            owner, name, orig = self.undo.pop()
            setattr(owner, name, orig)

    def by_source(self) -> dict:
        out = {s: dict.fromkeys(LaunchTally.KERNELS, 0) for s in self.SOURCES}
        for (_who, _h, source), row in self.counts.items():
            for name, n in row.items():
                out[source][name] += n
        return out

    def per_validator(self, height: int) -> dict:
        """{validator: launches} of the work at `height` on each validator."""
        out = {}
        for (who, h, source), row in self.counts.items():
            if h == height and who in self.by_name and source == "validators":
                cell = out.setdefault(who, dict.fromkeys(LaunchTally.KERNELS, 0))
                for name, n in row.items():
                    cell[name] += n
        return dict(sorted(out.items()))


def card_busy(fn):
    """(fn(), card busy ms, wall ms) of one call under a torch.profiler trace
    of the card's activity only (kernels, copies, fills); busy is None when
    the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA) / 1e3
    return out, (busy or None), wall_ms


def scenario_cell(tally: ScenarioTally, doc: dict, dev: torch.device, base_mib: float, profiled: bool = True,
                  on_card: bool | None = None) -> tuple[dict, dict]:
    """One run_scenario of `doc` on `dev`: (verdict, row) with the wall
    time, the verdict's metrics, the launches (by source), the counters
    that moved, the peak memory above the phase's start and the card's
    busy share."""
    counters0 = dict(telemetry.snapshot()["counters"])
    launches0 = read_counts()
    tally.reset()
    on_card = dev.type == "cuda" if on_card is None else on_card
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix=f"chip-smoke-sim-{doc['name']}-") as work:
        run = lambda: scenarios.run_scenario(dict(doc), workdir=work, device=dev)  # noqa: E731
        t0 = time.perf_counter()
        if on_card and profiled:
            v, busy_ms, wall_ms = card_busy(run)
        else:
            v, busy_ms, wall_ms = run(), None, None
        wall = time.perf_counter() - t0
    launches = counts_since(launches0)
    tel = telemetry.snapshot()["counters"]
    moved = {name: tel.get(name, 0) - counters0.get(name, 0) for name in tel if tel.get(name, 0) != counters0.get(name, 0)}
    by_source = tally.by_source()
    if on_card:
        total = {name: sum(row[name] for row in by_source.values()) for name in LaunchTally.KERNELS}
        require(total == launches, f"{doc['name']}: the tally {total} is not the wrappers' count {launches}")
    else:
        require(launches == {"sha256_compress": 0, "rs_extend_lines": 0}, f"the CPU twin launched {launches}")
    row = {
        "scenario": doc["name"], "scheme": doc["scheme"], "device": str(dev), "wall_s": wall,
        "validators": v["validators"], "light_nodes": v["light_nodes"], "heights": doc["heights"],
        "heights_committed": v["heights_committed"], "blocks_to_detection": v["blocks_to_detection"],
        "liveness_gap_s": v["liveness_gap_s"], "recovery_s": v["recovery_s"],
        "false_condemnation_rate": v["false_condemnation_rate"], "light_halts": v["light_halts"],
        "unavailable_reports": v["unavailable_reports"], "dropped_msgs": v["dropped_msgs"], "events": v["events"],
        "launches": launches, "launches_by_source": by_source,
        "befp_verified": moved.get("daser.befp_verified", 0),
        "zero_counters_moved": {name: moved[name] for name in SCENARIO_ZERO if name in moved},
        "malformed_fraud_proofs": moved.get("light.malformed_fraud_proofs", 0),
        "trace_digest": v["trace_digest"], "peak_rss_bytes": v["peak_rss_bytes"],
    }
    if on_card:
        row.update(peak_mib_above_base=torch.cuda.max_memory_allocated() / 2**20 - base_mib,
                   card_busy_ms=busy_ms, card_busy_share=None if busy_ms is None else busy_ms / wall_ms)
    require(not row["zero_counters_moved"], f"{doc['name']}/{doc['scheme']}: counters moved: {row['zero_counters_moved']}")
    require(v["heights_committed"] == doc["heights"],
            f"{doc['name']}/{doc['scheme']}: {v['heights_committed']} of {doc['heights']} heights committed")
    return v, row


def check_matrix_verdict(name: str, scheme: str, v: dict, row: dict) -> None:
    """tests/test_scenarios.py's verdicts of the matrix cell."""
    what = f"{name}/{scheme}"
    if name == "honest":
        require(v["false_condemnation_rate"] == 0 and v["light_halts"] == 0, f"{what}: halts {v['light_halts']}")
        require(row["malformed_fraud_proofs"] == 0, f"{what}: malformed fraud proofs counted")
    elif name == "withhold-threshold":
        require(v["blocks_to_detection"] is not None and v["unavailable_reports"] >= 1,
                f"{what}: not detected ({v['unavailable_reports']} unavailable reports)")
        require(v["light_halts"] == 0 and v["false_condemnation_rate"] == 0, f"{what}: withholding condemned")
    elif name == "incorrect-coding":
        require(v["blocks_to_detection"] is not None and v["light_halts"] >= 1, f"{what}: no fraud-proof halt")
        require(v["false_condemnation_rate"] == 0, f"{what}: a false condemnation")
        # a light halts for bad encoding only after its proof verified
        require(row["befp_verified"] == v["light_halts"],
                f"{what}: {row['befp_verified']} verified proofs for {v['light_halts']} halts")
        if scheme == codec.RS2D_NAME:
            befp = row["launches_by_source"]["fraud_proofs"]
            require(befp["sha256_compress"] > 0 and befp["rs_extend_lines"] > 0,
                    f"{what}: the BEFPs were not checked on the card: {befp}")
    elif name == "partition-churn":
        require(v["dropped_msgs"] > 0 and v["recovery_s"] is not None, f"{what}: no cut or no recovery")
        require(v["false_condemnation_rate"] == 0, f"{what}: a false condemnation")


def traffic_heights(tally: ScenarioTally, n_validators: int) -> list[dict]:
    """Per height of the traffic cell: the square size, K1 and K2 launches
    per validator (of the work at that height: its square, provers and the
    PFB commitments of its admission), the host time between the first
    commits of consecutive heights, the PFBs the traffic waves submitted
    and the first validator accepted while the chain worked on it, and
    the PFBs its block confirmed."""
    out, prev = [], None
    for h in sorted(tally.heights):
        rec = tally.heights[h]
        per = tally.per_validator(h)
        waves = tally.waves.get(h, {"submitted": 0, "accepted": 0})
        out.append({
            "height": h, "k": rec["k"], "txs": rec["txs"], "pfbs_submitted": waves["submitted"],
            "pfbs_accepted": waves["accepted"], "pfbs_confirmed": rec["pfbs"],
            "host_s": None if prev is None else rec["t"] - prev,
            "k1_per_validator": sorted({row["sha256_compress"] for row in per.values()}),
            "k2_per_validator": sorted({row["rs_extend_lines"] for row in per.values()}),
            "validators_counted": len(per),
        })
        prev = rec["t"]
    require(all(r["validators_counted"] == n_validators for r in out), f"traffic heights: {out}")
    return out


def scenario_plane(dev: torch.device) -> dict:
    """The reference's scenario matrix (bench.py --scenario) on the card:
    tens of real ValidatorNodes and DASers on one seeded virtual timeline
    per cell, every square, prover, commitment, repair and BEFP through K1
    and K2. Returns the phase's launch counts."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    tally = ScenarioTally()
    tally.install()
    rows, twins = [], {}
    try:
        reset_counts()
        for name in SCENARIO_MATRIX:
            for scheme in SCENARIO_SCHEMES:
                doc = scenarios.scenario_spec(name, scheme, SCENARIO_SEED)
                v, row = scenario_cell(tally, doc, dev, base_mib)
                check_matrix_verdict(name, scheme, v, row)
                if scheme == codec.RS2D_NAME and name in SCENARIO_TWINS:
                    twins[name] = (doc, scenarios.verdict_bytes(v))
                rows.append(row)
                emit("scenario_cell", **row)

        doc = scenarios.scenario_spec("long-soak", codec.RS2D_NAME, SCENARIO_SEED)
        v, row = scenario_cell(tally, doc, dev, base_mib)
        soak = v["soak"]
        for resource in ("eds_evictions", "sig_evictions", "commitment_evictions", "mempool_expired",
                         "snapshot_writes", "pack_builds", "snapshot_prunes", "pack_prunes"):
            require(soak[resource] >= 2, f"long-soak: {resource} churned {soak[resource]} times: {soak}")
        require(v["asym_msgs"].get("corrupt", 0) > 0 and v["asym_msgs"].get("delay", 0) > 0,
                f"long-soak: asymmetric faults {v['asym_msgs']}")
        require(v["traffic"]["accepted"] > 0 and v["traffic"]["confirmed"] > 0, f"long-soak traffic {v['traffic']}")
        require(v["false_condemnation_rate"] == 0 and v["light_halts"] == 0, "long-soak: a light halted")
        row.update(soak=soak, traffic=v["traffic"], asym_msgs=v["asym_msgs"])
        rows.append(row)
        emit("scenario_cell", **row)

        # the same specs on the CPU in this process: byte-equal verdicts
        # (every height's block and app hash, the trace digest, detections)
        for name, (doc, card_bytes) in twins.items():
            v, row = scenario_cell(tally, doc, torch.device("cpu"), base_mib)
            same = scenarios.verdict_bytes(v) == card_bytes
            require(same, f"{name}: the CPU's verdict bytes differ from the card's")
            row["verdict_bytes_equal_to_card"] = same
            rows.append(row)
            emit("scenario_cell", **row)

        # squares at the App's cap: honest under txsim-shaped PFB traffic
        doc = scenarios.scenario_spec("honest", codec.RS2D_NAME, SCENARIO_SEED, ops=[dict(SCENARIO_TRAFFIC)])
        v, row = scenario_cell(tally, doc, dev, base_mib)
        require(v["false_condemnation_rate"] == 0 and v["light_halts"] == 0, "traffic: a light halted")
        per_height = traffic_heights(tally, v["validators"])
        full = [r["height"] for r in per_height if r["k"] == TRAFFIC_K]
        largest = max(r["k"] for r in per_height)
        require(len(full) >= TRAFFIC_MIN_FULL_HEIGHTS,
                f"traffic: heights {full} reach k = {TRAFFIC_K} (largest k {largest}): {per_height}")
        require(v["traffic"]["confirmed"] > 0, f"traffic: {v['traffic']}")
        require(sum(w["submitted"] for w in tally.waves.values()) == v["traffic"]["submitted"],
                f"traffic: waves {tally.waves} against {v['traffic']}")
        after = {h: w for h, w in tally.waves.items() if h > doc["heights"]}
        row.update(traffic=v["traffic"], per_height=per_height, full_heights=full, largest_k=largest,
                   pfbs_after_last_height={key: sum(w[key] for w in after.values())
                                           for key in ("submitted", "accepted")})
        rows.append(row)
        emit("scenario_cell", **row)

        # fleet scale: 1,000 continuation-driven lights, twice with one seed
        doc = scenarios.scenario_spec("fleet-scale", codec.RS2D_NAME, SCENARIO_SEED, heights=FLEET_HEIGHTS)
        fleet = []
        for _ in range(2):
            v, row = scenario_cell(tally, doc, dev, base_mib, profiled=False)
            require(v["sim_lights"] == doc["light_nodes"] and v["light_halts"] == 0 and v["false_condemnation_rate"] == 0,
                    f"fleet-scale: {v['sim_lights']} lights, {v['light_halts']} halts")
            fleet.append(scenarios.verdict_bytes(v))
            row["heights_cut_from"] = 1000
            rows.append(row)
            emit("scenario_cell", **row)
        require(fleet[0] == fleet[1], "fleet-scale: two runs with one seed differ")

        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        tally.remove()
    summary = [{key: r.get(key) for key in (
        "scenario", "scheme", "device", "wall_s", "blocks_to_detection", "liveness_gap_s", "recovery_s",
        "false_condemnation_rate", "launches_by_source", "peak_mib_above_base", "card_busy_share")}
        for r in rows]
    emit("scenario_plane", cells=summary, launches=counts, fleet_heights=FLEET_HEIGHTS,
         fleet_heights_cut_from=1000, fleet_verdict_bytes_identical=True,
         twins_byte_equal=sorted(twins), phase_s=time.perf_counter() - t_phase)
    return counts


CLI_CHAIN = "cli-plane"
CLI_SETUP_VALIDATORS = 4
CLI_SETUP_DEVICES = ("cuda", "cpu")  # the setup commands run once per device; the files must agree
# the upstream throughput class: tests/test_e2e_bench.py::test_e2e_bench_big_blocks_over_sockets, after
# celestia-app test/e2e/benchmark/throughput.go:105,124-125 (gov-max squares, k = 64)
CLI_E2E = ("--validators", "3", "--blocks", "5", "--blob-kb", "200", "--blobs-per-tx", "1",
           "--txs-per-block", "10", "--latency-ms", "70", "--target-mb", "1.9", "--block-time", "1.0",
           "--chain-id", "e2e-bench-big")
CLI_VALIDATORS = 4
CLI_BLOCK_TIME = 1.0
CLI_TXSIM = ("--blob-sequences", "8", "--send-sequences", "2", "--blob-sizes", "100000-250000",
             "--blobs-per-pfb", "1-3", "--txs-per-sequence", "4")  # PR 12's traffic cell, over HTTP
CLI_FULL_K = 64  # the default square cap that full heights reach
# a quarter of blobload's default readers and half its requests: at its
# defaults (256 x 4 batched requests of 64 queries) it saturates the read
# plane for 82-251 s, most of them timed out, and the script nears its limit
CLI_BLOBLOAD = ("--readers", "64", "--requests", "2")
CLI_FUNDED_KEYS = 10  # `keys derive 0..9`: the txsim lanes' accounts
# the transfer-ledger sites this slice gave their reference names; the old
# port names must not appear
CLI_REPAIRED_SITES = {"proof.row_levels", "proof.levels", "namespace.leaf_mins", "ops.roots_dispatch",
                      "ops.roots_fetch", "ops.repair_dispatch", "ops.repair_fetch"}
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def port_cli(*argv: str, timeout: float = 600.0) -> tuple[subprocess.CompletedProcess, float]:
    """One `python -m celestia_app_tpu_torch` command from the repository
    root; it must exit 0. (the process, its wall seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "celestia_app_tpu_torch", *argv], capture_output=True, text=True,
                         timeout=timeout, cwd=REPO_ROOT)
    require(out.returncode == 0, f"`{' '.join(argv[:2])}` exited {out.returncode}: {out.stderr[-3000:]}")
    return out, time.perf_counter() - t0


def cli_setup(root: str, device: str) -> dict:
    """init, the genesis ceremony of CLI_SETUP_VALIDATORS validators, keys
    and config, all with `--device device`. Returns the home's files and
    the commands' outputs."""
    home = os.path.join(root, f"setup-{device}")
    dev = ("--device", device)
    out = {}
    out["init"] = port_cli("init", "--home", home, "--chain-id", CLI_CHAIN, *dev)[0].stdout.replace(home, "<home>")
    seeds = [f"cli-validator-{i}" for i in range(CLI_SETUP_VALIDATORS)]
    for i, seed in enumerate(seeds):  # each one rewrites genesis.json
        address = crypto.PrivateKey.from_seed(seed.encode()).public_key().address().hex()
        port_cli("genesis", "add-account", "--home", home, "--address", address, "--balance", str(10**12 + i), *dev)

    def together(*commands) -> list[str]:
        """Commands that touch different files, run at once: their stdout."""
        with concurrent.futures.ThreadPoolExecutor(len(commands)) as pool:
            return [r[0].stdout for r in pool.map(lambda argv: port_cli(*argv, *dev), commands)]

    gentxs = [("genesis", "gentx", "--home", home, "--seed", seed, "--moniker", f"cli-{i}", "--power", str(10 + i))
              for i, seed in enumerate(seeds)]
    *_, out["keys"], out["config_set"] = together(*gentxs, ("keys", "derive", "0"),
                                                  ("config", "set", "min_gas_price", "0.003", "--home", home))
    out["collect"] = port_cli("genesis", "collect-gentxs", "--home", home, *dev)[0].stdout
    out["validate"], config = together(("genesis", "validate", "--home", home), ("config", "get", "--home", home))
    out["config_get"] = json.loads(config)
    files = {}
    for dirpath, _, names in os.walk(home):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, home)] = f.read()
    return {"files": files, "out": out}


def exit_lines(homes: list[str]) -> list[dict]:
    """Each validator process's exit line (its device and launches), from
    its validator.log."""
    docs = []
    for home in homes:
        with open(os.path.join(home, "validator.log")) as f:
            found = [ln for ln in f.read().splitlines() if ln.startswith(port_cli_mod.EXIT_LINE_PREFIX)]
        require(len(found) == 1, f"{home}: {len(found)} exit lines")
        docs.append(json.loads(found[0][len(port_cli_mod.EXIT_LINE_PREFIX):]))
    return docs


def stored_blocks(home: str) -> list:
    db = storage.ChainDB(os.path.join(home, "data"), read_only=True)
    return [db.load_block(h) for h in db.block_heights()]


def check_children(dev: torch.device, homes: list[str], lines: list[dict]) -> list[dict]:
    """Every child ran on `dev` and, on a card, launched K1 and at least two
    K2 per non-empty height it committed. Per child: its line and heights."""
    rows = []
    for home, line in zip(homes, lines):
        blocks = stored_blocks(home)
        non_empty = sum(1 for b in blocks if b.txs)
        require(line["device"].split(":")[0] == dev.type, f"{home}: ran on {line['device']}, not {dev}")
        if dev.type == "cuda":
            require(line["k1_launches"] > 0 and line["k2_launches"] >= 2 * non_empty,
                    f"{home}: {line['k1_launches']} K1 and {line['k2_launches']} K2 for {non_empty} non-empty heights")
        rows.append({**line, "committed": len(blocks), "non_empty_heights": non_empty})
    return rows


def recompute_roots(dev: torch.device, homes: list[str]) -> dict:
    """Every committed height of every home: its square rebuilt from the
    stored block, its data root computed on `dev` and on the CPU, both
    equal to the committed root. A block stored in several homes is
    computed once."""
    done: dict[bytes, bytes] = {}
    checked = 0
    for home in homes:
        store = types.SimpleNamespace(db=storage.ChainDB(os.path.join(home, "data"), read_only=True))
        for h in store.db.block_heights():
            blk, sq = query.rebuild_square(store, h)
            key = hashlib.sha256(b"".join(hashlib.sha256(t).digest() for t in blk.txs)
                                 + blk.header.app_version.to_bytes(8, "big")).digest()
            if key not in done:
                ods = dah.shares_to_ods(sq.share_bytes())
                card = dah.new_dah_from_ods(ods, device=dev)[2]
                host = dah.new_dah_from_ods(ods, device="cpu")[2]
                require(card == host, f"{home} height {h}: the card's data root differs from the CPU's")
                done[key] = card
            require(done[key] == blk.header.data_hash, f"{home} height {h}: the recomputed data root differs")
            checked += 1
    return {"heights_checked": checked, "distinct_blocks": len(done)}


def cli_e2e_bench(dev: torch.device, root: str) -> dict:
    home = os.path.join(root, "e2e")
    out, seconds = port_cli("e2e-bench", "--home", home, *CLI_E2E, "--device", dev.type, timeout=900)
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    require(doc["pass"] is True and doc["max_block_bytes"] >= 0.9 * doc["target_bytes"], f"e2e-bench: {doc}")
    homes = [os.path.join(home, f"val{i}") for i in range(doc["validators"])]
    children = check_children(dev, homes, exit_lines(homes))
    # launches the recomputation makes are a comparison: outside the path's counts
    roots = recompute_roots(dev, homes)
    squares = {b.header.height: b.header.square_size for b in stored_blocks(homes[0])}
    return {"s": seconds, "summary": doc, "children": children, "roots": roots, "squares": squares}


def cli_network(dev: torch.device, root: str) -> dict:
    """CLI_VALIDATORS autonomous validator processes through the port's
    spawner; txsim, dasload, blobload and timeline against them; a clean
    stop; blocktime and blockscan over validator 0's home."""
    privs = [crypto.PrivateKey.from_seed(f"devnet-{i}".encode()) for i in range(CLI_VALIDATORS)]
    keys = [crypto.PrivateKey.from_seed(str(i).encode()) for i in range(CLI_FUNDED_KEYS)]
    genesis = {
        "time_unix": time.time(),
        "accounts": [{"address": p.public_key().address().hex(), "balance": 10**14} for p in privs + keys],
        "validators": [{"operator": p.public_key().address().hex(), "power": 10,
                        "pubkey": p.public_key().compressed.hex()} for p in privs],
    }
    args = types.SimpleNamespace(home=os.path.join(root, "net"), validators=CLI_VALIDATORS, chain_id=CLI_CHAIN,
                                 device=dev.type)
    t0 = time.perf_counter()
    procs, homes, urls = port_cli_mod._spawn_validator_processes(
        args, genesis, extra_flags=("--autonomous", "--http", "0"),
        reactor_cfg={"timeout_propose": 30.0, "timeout_prevote": 15.0, "timeout_precommit": 15.0,
                     "timeout_delta": 2.0, "block_interval": CLI_BLOCK_TIME})
    steps = {}
    try:
        for home in homes:
            with open(os.path.join(home, "peers.json.tmp"), "w") as f:
                json.dump(urls, f)
            os.replace(os.path.join(home, "peers.json.tmp"), os.path.join(home, "peers.json"))
        http = []
        for home in homes:
            with open(os.path.join(home, "endpoint.json")) as f:
                http.append(f"http://127.0.0.1:{json.load(f)['http_port']}")
        deadline = time.monotonic() + NETWORK_WAIT_S
        while min(transport.request_json(u, "/status")["height"] for u in http) < 1:
            require(time.monotonic() < deadline, "the validator processes never committed height 1")
            time.sleep(0.2)
        steps["come_up"] = {"s": time.perf_counter() - t0}

        out, seconds = port_cli("txsim", *(f"--url={u}" for u in http), *CLI_TXSIM, "--device", dev.type, timeout=600)
        rep = json.loads(out.stdout)
        require(rep["errors"] == 0 and rep["pfbs_confirmed"] > 0, f"txsim: {rep}")
        steps["txsim"] = {"s": seconds, **{k: rep[k] for k in (
            "pfbs_submitted", "pfbs_accepted", "pfbs_confirmed", "sends_submitted", "sends_accepted",
            "sends_confirmed", "blobs_confirmed", "bytes_submitted", "resyncs", "errors",
            "admission_commit_p50_ms", "admission_commit_p99_ms", "blobs_per_sec")}}

        head = transport.request_json(http[0], "/status")["height"]
        answers = {h: transport.request_json(http[0], f"/block/{h}") for h in range(1, head + 1)}
        pfb_heights, namespaces = [], []
        for h, doc in answers.items():
            raws = [base64.b64decode(t) for t in doc["txs"]]
            blob_txs = [blob.unmarshal_blob_tx(r) for r in raws if blob.is_blob_tx(r)]
            if blob_txs:
                pfb_heights.append(h)
            for btx in blob_txs:
                for b in btx.blobs:
                    if b.namespace.raw.hex() not in namespaces:
                        namespaces.append(b.namespace.raw.hex())
        full = [h for h, doc in answers.items() if doc["square_size"] == CLI_FULL_K]
        require(full, f"no height fills a k = {CLI_FULL_K} square: {[d['square_size'] for d in answers.values()]}")
        steps["heights"] = {"head": head, "pfb_heights": pfb_heights, "full_heights": full,
                            "squares": {h: d["square_size"] for h, d in answers.items()}}

        out, seconds = port_cli("dasload", "--url", http[0], "--heights", ",".join(map(str, pfb_heights[-8:])),
                                "--device", dev.type, timeout=600)
        das_rep = json.loads(out.stdout)
        require(das_rep["chunk_hash_mismatches"] == 0 and das_rep["samples"] > 0, f"dasload: {das_rep}")
        steps["dasload"] = {"s": seconds, **das_rep}

        out, seconds = port_cli("blobload", "--url", http[0], "--heights", ",".join(map(str, pfb_heights[-4:])),
                                "--namespaces", ",".join(namespaces), *CLI_BLOBLOAD, "--device", dev.type,
                                timeout=600)
        blob_rep = json.loads(out.stdout)
        require(blob_rep["chunk_hash_mismatches"] == 0 and blob_rep["namespace_queries"] > 0
                and blob_rep["present_ratio"] > 0, f"blobload: {blob_rep}")
        steps["blobload"] = {"s": seconds, **blob_rep}

        out, seconds = port_cli("timeline", "--nodes", ",".join(http), "--json", "--limit", "100000",
                                "--device", dev.type, timeout=300)
        doc = json.loads(out.stdout)
        sites = sorted({row["site"] for rows in doc["traces"].values() for row in rows
                        if row.get("table") == xfer.XFER_TABLE})
        require(sites and not any(s.startswith("proof_device.") for s in sites), f"timeline sites: {sites}")
        repaired = sorted(set(sites) & CLI_REPAIRED_SITES)
        require(repaired, f"no repaired site among the timeline's leaves: {sites}")
        steps["timeline"] = {"s": seconds, "traces": len(doc["traces"]), "heights": len(doc["heights"]),
                             "xfer_sites": sites, "repaired_sites_seen": repaired}
    finally:
        port_cli_mod._terminate_processes(procs)
    children = check_children(dev, homes, exit_lines(homes))

    scan, seconds = port_cli("blockscan", "--home", homes[0], "--device", dev.type)
    rows = {r["height"]: r for r in map(json.loads, scan.stdout.splitlines())}
    require(all(h in rows and rows[h]["square_size"] == d["square_size"] and rows[h]["data_hash"] == d["data_hash"]
                for h, d in answers.items()), "blockscan differs from the node's /block answers")
    times, _ = port_cli("blocktime", "--home", homes[0], "--device", dev.type)
    blocktime = json.loads(times.stdout)
    require(blocktime["blocks"] == len(rows) and blocktime["to_height"] == max(rows), f"blocktime: {blocktime}")
    steps["inspection"] = {"blockscan_s": seconds, "heights": len(rows), "blocktime": blocktime,
                           "blocks_per_s": 1 / blocktime["avg_interval_s"] if blocktime["avg_interval_s"] else None}
    return {"steps": steps, "children": children, "s": time.perf_counter() - t0}


def cli_plane(dev: torch.device) -> dict:
    """The port's command line on the card, driven only through
    `python -m celestia_app_tpu_torch` (and its own spawner): the setup
    commands on both devices, the upstream throughput class through
    e2e-bench, and a four-validator process network under txsim, dasload,
    blobload and timeline, then blockscan and blocktime. Returns the K1
    and K2 launches of every validator process."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-cli-")
    try:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(CLI_SETUP_DEVICES)) as pool:
            setups = dict(zip(CLI_SETUP_DEVICES, pool.map(lambda d: cli_setup(root, d), CLI_SETUP_DEVICES)))
        first, second = (setups[d] for d in CLI_SETUP_DEVICES)
        require(sorted(first["files"]) == sorted(second["files"]), "the setup homes hold other files")
        for name, data in first["files"].items():
            other = second["files"][name]
            if name == "config.json":
                # the one difference: the device each home was made for
                a, b = json.loads(data), json.loads(other)
                require((a.pop("device"), b.pop("device")) == CLI_SETUP_DEVICES and a == b,
                        "config.json differs beyond device")
            elif name == "genesis.json":
                # init stamps the wall clock into the genesis time
                a, b = json.loads(data), json.loads(other)
                a.pop("time_unix"), b.pop("time_unix")
                require(a == b, "genesis.json differs beyond its time")
            else:
                require(data == other, f"{name} differs between the devices")
        for step in ("init", "collect", "validate", "keys", "config_set"):
            require(first["out"][step] == second["out"][step], f"`{step}` printed differently")
        require(len(json.loads(first["files"]["genesis.json"])["validators"]) == CLI_SETUP_VALIDATORS + 1,
                "collect-gentxs merged the wrong validator set")
        setup = {"s": time.perf_counter() - t0, "files": len(first["files"]), "devices": list(CLI_SETUP_DEVICES)}
        emit("cli_setup", **setup)

        e2e = cli_e2e_bench(dev, root)
        emit("cli_e2e_bench", **e2e)
        net = cli_network(dev, root)
        emit("cli_network", **net)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    children = e2e["children"] + net["children"]
    counts = {"sha256_compress": sum(c["k1_launches"] for c in children),
              "rs_extend_lines": sum(c["k2_launches"] for c in children)}
    emit("cli_plane", setup_s=setup["s"], e2e_bench_s=e2e["s"], network_s=net["s"], launches=counts,
         children=[{k: c[k] for k in ("name", "device", "height", "k1_launches", "k2_launches", "peak_mib",
                                      "non_empty_heights")} for c in children],
         dasload_ms=[net["steps"]["dasload"]["p50_ms"], net["steps"]["dasload"]["p99_ms"]],
         blobload_ms=[net["steps"]["blobload"]["p50_ms"], net["steps"]["blobload"]["p99_ms"]],
         e2e_blocks_per_s=e2e["summary"]["blocks_per_sec"],
         network_blocks_per_s=net["steps"]["inspection"]["blocks_per_s"],
         phase_s=time.perf_counter() - t_phase)
    return counts


MESH_SHAPES = ((128, 1, 2, 2), (128, 1, 4, 2), (128, 2, 2, 2), (256, 1, 4, 1), (512, 1, 4, 1))  # (k, data, seq, B)
MESH_CARDS_SHAPES = ((128, 2), (256, 1), (512, 1))  # (k, B) over every card, when there are several
MESH_SHARDS = 4  # the [cuda:0] * 4 mesh of the entry, repair, App and streaming checks
MESH_ENTRY_K = 256  # the mesh entry, App and streaming checks on explicit meshes
MESH_STREAM_BATCHES = 3
MESH_MULTIHOST = ("--processes", "2", "--devices-per-host", "2", "--k", "64", "--batch", "2")


def mesh_launches(k: int, n_shards: int) -> dict:
    """K1 and K2 launches of one sharded dispatch over n shards: per shard a
    row and a column pass (K2 in GF(2^8)), one leaf launch and log2(2k)
    inner levels for each orientation; one data-root tree on the lead."""
    log2_2k = int(math.log2(2 * k))
    return {"sha256_compress": n_shards * (1 + 2 * log2_2k) + 1 + int(math.log2(4 * k)),
            "rs_extend_lines": 0 if leopard.uses_gf16(k) else 2 * n_shards}


def same_proof(a, b) -> bool:
    (sa, pa), (sb, pb) = a, b
    return sa == sb and (pa.start, pa.end, pa.total, list(pa.nodes)) == (pb.start, pb.end, pb.total, list(pb.nodes))


def mesh_app_heights(dev: torch.device, mesh, honest_raws: list[bytes]) -> dict:
    """The admission plane's raws through an App with a 256 square cap and
    produce_batch 2: (block hashes, app hash, squares' k, sharded
    dispatches' shapes, edscache crossings of the produce path)."""
    from celestia_app_tpu_torch.parallel import sharded_eds

    gen = node_genesis()
    gen["gov_max_square_size"] = MESH_ENTRY_K
    app = app_mod.App(chain_id="chip-smoke", app_version=3, device=dev, mesh=mesh, max_square_size=MESH_ENTRY_K)
    app.init_chain(gen)
    node = node_mod.Node(app)
    results = node.broadcast_txs(honest_raws)
    refused = [r.log for r in results if r.code != 0]
    require(not refused, f"the App refused {len(refused)} honest txs, first {refused[:1]}")
    real, dispatches = sharded_eds.sharded_pipeline, []

    def counting(m, ods):
        dispatches.append({"k": int(ods.shape[1]), "blocks": int(ods.shape[0]), **m.shape})
        return real(m, ods)

    sharded_eds.sharded_pipeline = counting
    try:
        x0 = edscache.crossings()["host_crossings"]
        out = node.produce_blocks_batched(2, t=NODE_T0 + 10)
        app.da_warmer.wait_idle()
        crossed = edscache.crossings()["host_crossings"] - x0
    finally:
        sharded_eds.sharded_pipeline = real
    return {"hashes": [blk.header.hash().hex() for blk, _ in out], "app_hash": app.last_app_hash.hex(),
            "k": [blk.header.square_size for blk, _ in out], "dispatches": dispatches, "crossings": crossed,
            "left_in_pool": len(node.pool)}


def all_cards_ms(fn, reps: int) -> float:
    """Mean host ms of fn() with every card synchronised before and after."""
    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def mesh_over_cards(dev: torch.device) -> dict:
    """With several cards: the sharded pipeline over all of them (peer
    copies) against one card at k = 128, 256 and 512, and the auto rule
    (mesh=None): a k = 256 square stays on one card, a k = 512 entry, its
    half-columns repair and a batched dispatch of two k = 512 squares shard
    over the cards, each byte-equal to one card's. Not counted in the
    launch paths."""
    from celestia_app_tpu_torch.parallel import mesh as mesh_mod
    from celestia_app_tpu_torch.parallel import sharded_eds

    rng = np.random.default_rng(SEED + 92)

    def ods_of(b: int, k: int) -> np.ndarray:
        ods = rng.integers(0, 256, size=(b, k, k, appconsts.SHARE_SIZE), dtype=np.uint8)
        ods[..., :29] = 0
        ods[..., 28] = 7
        return ods

    out = {"cards": torch.cuda.device_count(), "shapes": []}
    for k, b in MESH_CARDS_SHAPES:
        m = mesh_mod.make_mesh(k=k)
        ods = xfer.to_device(ods_of(b, k), "chip_smoke.mesh_plane", device=dev)
        got, want = sharded_eds.sharded_pipeline(m, ods), eds.pipeline_batched(ods, dev)
        require(all(torch.equal(g, w) for g, w in zip(got, want)), f"k={k} over {m.shape} differs from one card")
        del got, want
        out["shapes"].append({"k": k, "blocks": b, **m.shape,
                              "sharded_ms": all_cards_ms(lambda: sharded_eds.sharded_pipeline(m, ods), 3),
                              "one_card_ms": all_cards_ms(lambda: eds.pipeline_batched(ods, dev), 3)})
        emit("mesh_cards_shape", **out["shapes"][-1])
    k_auto, one_card = mesh_engine.DEFAULT_MESH_MIN_K, mesh_mod.Mesh(((dev,),))
    require(mesh_engine.mesh_active_for(k_auto, None, dev) and not mesh_engine.mesh_active_for(k_auto // 2, None, dev),
            f"the auto rule does not shard exactly the squares of k >= {k_auto} over the cards")
    ods = ods_of(1, k_auto)[0]
    s0 = telemetry.snapshot()["counters"].get("mesh.batch_shards", 0)
    entry = edscache.compute_entry(ods, dev)
    one = edscache.compute_entry(ods, dev, mesh=one_card)
    require(isinstance(entry, edscache.DeviceEntry) and entry.data_root == one.data_root and entry.dah == one.dah,
            "the auto rule's entry differs from one card's")
    eds_np = np.asarray(one.eds.squares)
    present = np.ones(eds_np.shape[:2], dtype=bool)
    present[:, 1::2] = False
    damaged = eds_np.copy()
    damaged[~present] = 0
    fixed = repair.repair_eds(damaged, present, list(one.dah.row_roots), list(one.dah.col_roots), device=dev)
    out["repair_batch_shards"] = telemetry.snapshot()["counters"].get("mesh.batch_shards", 0) - s0
    require(np.array_equal(fixed, eds_np) and out["repair_batch_shards"] > 0,
            "the auto rule's repair differs or did not shard")
    del eds_np, damaged, fixed, entry, one
    batch = ods_of(2, k_auto)
    real, dispatches = sharded_eds.sharded_pipeline, []

    def counting(m, ods_batch):
        dispatches.append(m.shape)
        return real(m, ods_batch)

    sharded_eds.sharded_pipeline = counting
    try:
        entries = mesh_engine.compute_entries_batched(batch, device=dev)
    finally:
        sharded_eds.sharded_pipeline = real
    want = mesh_engine.compute_entries_batched(batch, mesh=one_card)
    out["batched_on"] = sorted({str(e.device) for e in entries})
    out["batched_dispatches"] = dispatches
    require(len(dispatches) == 1 and dispatches[0][mesh_mod.SEQ_AXIS] >= 2,
            f"the auto rule's batched dispatch did not shard: {dispatches}")
    require(out["batched_on"] == [str(mesh_engine.card_mesh().lead)],
            f"the batched entries are on {out['batched_on']}, not on the lead card")
    require(all(e.data_root == w.data_root and e.dah == w.dah for e, w in zip(entries, want)),
            "the auto rule's batched entries' roots differ from one card's")
    emit("mesh_cards", **out)
    return out


def mesh_plane(dev: torch.device, honest_raws: list[bytes]) -> dict:
    """The mesh plane on the card: the sharded pipeline on meshes of
    [cuda:0] * n against the one-card pipeline, with K1 and K2 pinned per
    dispatch; the auto rule (no mesh on one card); compute_entry through a
    mesh (proofs, residency, repair); a mesh App's heights against a
    one-card App's; mesh streaming; the two-host gloo dryrun on cuda.
    Returns the launch counts of the counted runs."""
    from celestia_app_tpu_torch.parallel import mesh as mesh_mod
    from celestia_app_tpu_torch.parallel import sharded_eds

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    counts = {"sha256_compress": 0, "rs_extend_lines": 0}
    if cards == 1:
        require(all(mesh_engine.mesh_for(k) is None for k in (1, 2, 128, 256, 512)),
                "mesh_for found a mesh on a one-card host")
        require(mesh_engine.card_mesh() is None and not mesh_engine.mesh_active_for(512, None, dev),
                "the auto rule shards on one card")
    rng = np.random.default_rng(SEED + 90)

    def ods_batch(k: int, b: int) -> torch.Tensor:
        ods = rng.integers(0, 256, size=(b, k, k, appconsts.SHARE_SIZE), dtype=np.uint8)
        ods[..., :29] = 0
        ods[..., 28] = 7
        return xfer.to_device(ods, "chip_smoke.mesh_plane", device=dev)

    shapes = []
    for k, n_data, n_seq, b in MESH_SHAPES:
        m = mesh_mod.Mesh(((dev,) * n_seq,) * n_data)
        ods = ods_batch(k, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        got = sharded_eds.sharded_pipeline(m, ods)
        torch.cuda.synchronize()
        launched = read_counts()
        sharded_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        want_launches = mesh_launches(k, n_data * n_seq)
        require(launched == want_launches, f"k={k} ({n_data}, {n_seq}) launches {launched} != {want_launches}")
        add_counts(counts, launched)
        torch.cuda.reset_peak_memory_stats()
        want = eds.pipeline_batched(ods, dev)
        torch.cuda.synchronize()
        one_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        for name, g, w in zip(("eds", "row_roots", "col_roots", "data_roots"), got, want):
            require(torch.equal(g, w), f"k={k} ({n_data}, {n_seq}) {name} differ from the one-card pipeline")
        del got, want
        reps = 5 if k <= 128 else 2
        sharded_ms = cuda_ms(lambda: sharded_eds.sharded_pipeline(m, ods), reps, warmup=1)
        one_ms = cuda_ms(lambda: eds.pipeline_batched(ods, dev), reps, warmup=1)
        shapes.append({"k": k, "data": n_data, "seq": n_seq, "blocks": b, "launches": launched,
                       "sharded_ms": sharded_ms, "one_card_ms": one_ms, "sharded_over_one": sharded_ms / one_ms,
                       "sharded_peak_mib": sharded_mib, "one_card_peak_mib": one_mib})
        emit("mesh_shape", **shapes[-1])
        del ods
        torch.cuda.empty_cache()

    peers = mesh_over_cards(dev) if cards > 1 else None

    # compute_entry through a mesh at k = 256: proofs, residency, repair
    m4 = mesh_mod.Mesh(((dev,) * MESH_SHARDS,))
    txs, pfbs = big_block(SEED + 91, dict(BIG_BLOCKS)[MESH_ENTRY_K])
    sq = square.build(txs, pfbs, BIG_SQUARE_MAX, appconsts.SUBTREE_ROOT_THRESHOLD)
    require(sq.size == MESH_ENTRY_K, f"the mesh block built k={sq.size}")
    ods = dah.shares_to_ods(sq.share_bytes())
    reset_counts()
    entry = edscache.compute_entry(ods, dev, mesh=m4)
    torch.cuda.synchronize()
    entry_launches = read_counts()
    require(isinstance(entry, edscache.DeviceEntry), "compute_entry through the mesh gave a host entry")
    require(entry_launches == mesh_launches(MESH_ENTRY_K, MESH_SHARDS), f"entry launches {entry_launches}")
    add_counts(counts, entry_launches)
    one = edscache.compute_entry(ods, dev)
    require(entry.data_root == one.data_root and entry.dah == one.dah, "the mesh entry's commitments differ")
    x0 = edscache.crossings()["host_crossings"]
    reset_counts()
    entry.warm()
    torch.cuda.synchronize()
    add_counts(counts, read_counts())
    require(edscache.crossings()["host_crossings"] == x0, "warming the mesh entry crossed to the host")
    prover, one_prover = entry.get_prover(), one.get_prover(device=dev)
    cells = [(0, 0), (MESH_ENTRY_K - 1, MESH_ENTRY_K), (2 * MESH_ENTRY_K - 1, 3)]
    require(all(same_proof(prover.prove_cell(r, c), one_prover.prove_cell(r, c)) for r, c in cells),
            "a share proof of the mesh entry differs")
    ns = pfbs[0].blobs[0].namespace.raw
    reset_counts()
    (nd,) = namespace_device.get_namespace_data_batched(entry, [ns], device=dev)
    add_counts(counts, read_counts())
    (want_nd,) = namespace_device.get_namespace_data_batched(one_prover, [ns], device=dev)
    require(nd == want_nd and nd.shares and namespace_data.verify_namespace_data(entry.dah, ns, nd),
            "the namespace proof of the mesh entry differs or does not verify")

    eds_np = np.asarray(one.eds.squares)
    present = np.ones(eds_np.shape[:2], dtype=bool)
    present[:, 1::2] = False  # half the columns withheld
    damaged = eds_np.copy()
    damaged[~present] = 0
    s0 = telemetry.snapshot()["counters"].get("mesh.batch_shards", 0)
    reset_counts()
    fixed, repair_s = timed(lambda: repair.repair_eds(damaged, present, list(one.dah.row_roots),
                                                      list(one.dah.col_roots), device=dev, mesh=m4))
    repair_launches = read_counts()
    add_counts(counts, repair_launches)
    shards = telemetry.snapshot()["counters"].get("mesh.batch_shards", 0) - s0
    require(np.array_equal(fixed, eds_np), "the mesh-sharded repair differs from the square")
    log2_2k = int(math.log2(2 * MESH_ENTRY_K))
    want_repair = {"sha256_compress": 2 * MESH_SHARDS * (1 + log2_2k), "rs_extend_lines": 0}
    require(repair_launches == want_repair and shards >= 4,
            f"repair launches {repair_launches} != {want_repair}, {shards} batch shards")
    del eds_np, damaged, fixed, entry, one, prover, one_prover

    # a mesh App's heights against a one-card App's
    reset_counts()
    mesh_run = mesh_app_heights(dev, m4, honest_raws)
    add_counts(counts, read_counts())
    one_run = mesh_app_heights(dev, None, honest_raws)
    require(mesh_run["hashes"] == one_run["hashes"] and mesh_run["app_hash"] == one_run["app_hash"],
            "the mesh App's blocks differ from the one-card App's")
    require(any(d["k"] == MESH_ENTRY_K and d["seq"] == MESH_SHARDS for d in mesh_run["dispatches"])
            and (cards > 1 or not one_run["dispatches"]), f"mesh App dispatches {mesh_run['dispatches']}")
    require(mesh_run["crossings"] == 0, f"the mesh App's produce path crossed {mesh_run['crossings']} times")

    # mesh streaming at k = 256
    reset_counts()
    stream = streaming.bench_stream_mesh(k=MESH_ENTRY_K, n_batches=MESH_STREAM_BATCHES, n_devices=MESH_SHARDS,
                                         devices=[dev] * MESH_SHARDS)
    stream_launches = read_counts()
    require(stream_launches == {n: (MESH_STREAM_BATCHES + 1) * c for n, c in
                                mesh_launches(MESH_ENTRY_K, MESH_SHARDS).items()},
            f"streaming launches {stream_launches}")
    add_counts(counts, stream_launches)
    layouts = [streaming._synthetic_layout(MESH_ENTRY_K, i)[None] for i in range(MESH_STREAM_BATCHES)]
    stream_profile = device_profile(
        "mesh_stream_profile", lambda: streaming.stream_blocks_mesh(lambda i: layouts[i], MESH_STREAM_BATCHES,
                                                                     m4, MESH_ENTRY_K),
        stream["elapsed_s"] * 1e3, reps=1)

    # two hosts over gloo, each with two shards on this card
    out, dryrun_s = port_cli("multihost-dryrun", *MESH_MULTIHOST, "--device", "cuda", timeout=300.0)
    dry = json.loads(out.stdout.strip().splitlines()[-1])
    require(dry["all_hosts_match_oracle"] is True and torch.device(dry["device"]).type == dev.type,
            f"multihost dryrun {dry}")
    k_mh, per_host = 64, 2
    want_host = mesh_launches(k_mh, per_host)  # each host reduces the whole batch's data roots
    require(all(h == want_host for h in dry["host_launches"]), f"multihost launches {dry['host_launches']}")
    for h in dry["host_launches"]:
        add_counts(counts, h)

    emit("mesh_plane", device_count=cards, shapes=shapes, peers=peers, entry_launches=entry_launches,
         repair_launches=repair_launches, repair_s=repair_s, repair_batch_shards=shards,
         app={"hashes": mesh_run["hashes"], "k": mesh_run["k"], "dispatches": mesh_run["dispatches"],
              "crossings": mesh_run["crossings"]},
         stream={"blocks_per_s": stream["value"], "blocks": stream["blocks"], "mesh": stream["mesh"],
                 "card_idle_share": stream_profile["idle_share"]},
         multihost={k: dry[k] for k in ("global_devices", "mesh", "device", "pipeline_s", "exchanged_bytes",
                                        "host_launches", "all_hosts_match_oracle")}, multihost_s=dryrun_s,
         launches=counts, phase_s=time.perf_counter() - t_phase)
    return counts


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


def big_block(seed: int, blob_bytes: int) -> tuple[list[bytes], list[square.PfbEntry]]:
    """Seeded mempool contents shaped like the upstream e2e big-block
    manifests (test/e2e/benchmark/throughput.go: blob sequences of 6 blobs
    of 200 KB, GovMaxSquareSize 512): PFBs of 6 blobs of 200 KB under 8
    version-0 namespaces until `blob_bytes` is reached, and 20 plain txs."""
    rng = np.random.default_rng(seed)
    namespaces = [namespace.Namespace.v0(rng.bytes(10)) for _ in range(8)]
    txs = [rng.bytes(int(rng.integers(150, 400))) for _ in range(20)]
    pfbs, total = [], 0
    while total < blob_bytes:
        blobs = tuple(blob.Blob(namespaces[int(rng.integers(0, len(namespaces)))], rng.bytes(BIG_BLOB_BYTES))
                      for _ in range(BIG_BLOBS_PER_PFB))
        pfbs.append(square.PfbEntry(rng.bytes(int(rng.integers(250, 450))), blobs))
        total += BIG_BLOBS_PER_PFB * BIG_BLOB_BYTES
    return txs, pfbs


def host_axis_roots(eds_np: np.ndarray) -> tuple[list[bytes], list[bytes]]:
    """Row and column NMT roots of an extended square on the host: numpy
    level by level, every hash through hashlib (utils/fast_host.sha_many);
    the leaf rule and the node rule of ops/nmt written out again."""
    two_k = eds_np.shape[0]
    k = two_k // 2
    ns_len = appconsts.NAMESPACE_SIZE
    parity = np.frombuffer(namespace.PARITY_NS_RAW, dtype=np.uint8)
    in_q0 = (np.arange(two_k)[:, None] < k) & (np.arange(two_k)[None, :] < k)
    ns = np.where(in_q0[..., None], eds_np[..., :ns_len], parity)
    pre = np.zeros((two_k * two_k, 1 + ns_len + appconsts.SHARE_SIZE), dtype=np.uint8)
    pre[:, 1:1 + ns_len] = ns.reshape(-1, ns_len)
    pre[:, 1 + ns_len:] = eds_np.reshape(-1, appconsts.SHARE_SIZE)
    v = fast_host.sha_many(pre).reshape(two_k, two_k, 32)
    del pre
    mins = np.concatenate([ns, ns.swapaxes(0, 1)])  # rows, then columns: (4k, 2k, 29)
    maxs, vs = mins, np.concatenate([v, v.swapaxes(0, 1)])

    def less(a, b):
        first = (a != b).argmax(axis=-1)[..., None]
        return np.take_along_axis(a, first, -1)[..., 0] < np.take_along_axis(b, first, -1)[..., 0]

    while mins.shape[1] > 1:
        lmin, rmin, lmax, rmax = mins[:, 0::2], mins[:, 1::2], maxs[:, 0::2], maxs[:, 1::2]
        t, half = lmin.shape[:2]
        pre = np.concatenate([np.ones((t, half, 1), dtype=np.uint8), lmin, lmax, vs[:, 0::2],
                              rmin, rmax, vs[:, 1::2]], axis=2)
        vs = fast_host.sha_many(pre.reshape(t * half, -1)).reshape(t, half, 32)
        l_parity = (lmin == parity).all(-1)[..., None]
        r_parity = (rmin == parity).all(-1)[..., None]
        mins = np.where(less(lmin, rmin)[..., None], lmin, rmin)
        maxs = np.where(l_parity, parity, np.where(r_parity, lmax, np.where(less(lmax, rmax)[..., None], rmax, lmax)))
    roots = [r.tobytes() for r in np.concatenate([mins[:, 0], maxs[:, 0], vs[:, 0]], axis=1)]
    return roots[:two_k], roots[two_k:]


def gf16_bound_ms(k: int) -> tuple[float, str]:
    """Least time of the 16-bit extension's products: 3 passes of (16k)^2 x
    k x 256 multiply-adds (2 operations each) against the int8 tensor-core
    rate, or its bytes (the ODS read, three quadrants written, the matrix)."""
    ops_s = 2 * 3 * (16 * k) ** 2 * k * (appconsts.SHARE_SIZE // 2) / INT8_TENSOR_OPS_PER_S
    bytes_s = (4 * k * k * appconsts.SHARE_SIZE + (16 * k) ** 2) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def gf16_product_ms(k: int, ods_dev: torch.Tensor) -> float:
    """CUDA-event time of the products alone in one 16-bit extension: one
    chunk's torch._int_mm, times the chunks of a pass, times 3 passes."""
    per = min(k, max(1, rs.GF16_CHUNK_BYTES // (rs.SYMBOLS * 16 * k * 4)))
    x = rs.bytes_to_bits16(ods_dev[:per]).reshape(-1, 16 * k)
    matrix = rs.bit_operand16(k, ods_dev.device)
    return cuda_ms(lambda: torch._int_mm(x, matrix.t()), reps=5, warmup=1) * (k // per) * 3


def big_blocks(dev: torch.device) -> tuple[dict, dict, dict]:
    """The k = 256 and 512 blocks: layout, new_dah_from_ods on the card, the
    host yardstick, times and peak memory. Returns (launch counts, report,
    each block's ODS, EDS and DAH by k for the repairs)."""
    counted, report, kept = {}, {}, {}
    for k, blob_bytes in BIG_BLOCKS:
        txs, pfbs = big_block(SEED + k, blob_bytes)
        (sq, layout_s) = timed(lambda: square.build(txs, pfbs, BIG_SQUARE_MAX, appconsts.SUBTREE_ROOT_THRESHOLD))
        ods = dah.shares_to_ods(sq.share_bytes())
        require(sq.size == k, f"a {blob_bytes / 1e6:.0f} MB block built a k={sq.size} square, not {k}")
        require(len(sq.share_bytes()) > (k // 2) ** 2, f"the k={k} block fits a smaller square")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mib = torch.cuda.memory_allocated() / 2**20
        reset_counts()
        (d, ext, root), wall_s = timed(lambda: dah.new_dah_from_ods(ods))
        counted[f"k{k}"] = read_counts()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        log2_2k = int(math.log2(2 * k))
        want = {"sha256_compress": 2 + log2_2k + log2_2k + 1, "rs_extend_lines": 0}
        require(counted[f"k{k}"] == want, f"k={k} block launches {counted[f'k{k}']} != {want}")
        d.validate_basic()
        (host_eds, host_rows, host_cols), host_s = timed(lambda: (lambda e: (e, *host_axis_roots(e)))(
            rs.extend_square_np(ods)))
        require(np.array_equal(ext.squares, host_eds), f"k={k} EDS differs from the host Leopard-16 encode")
        require(list(d.row_roots) == host_rows and list(d.col_roots) == host_cols,
                f"k={k} axis roots differ from the hashlib trees")
        require(root == merkle_host.hash_from_leaves(host_rows + host_cols) == d.hash(),
                f"k={k} data root differs from the host yardstick")
        ods_dev = torch.from_numpy(ods.copy()).to(dev)
        pipeline_ms = cuda_ms(lambda: eds.pipeline(ods_dev, dev), reps=3, warmup=1)
        extend = rs.extend_square_fn(k, dev)
        extend_ms = cuda_ms(lambda: extend(ods_dev), reps=3, warmup=1)
        product_ms = gf16_product_ms(k, ods_dev)
        bound_ms, bound_by = gf16_bound_ms(k)
        report[f"k{k}"] = {"blob_mb": sum(len(b.data) for e in sq.pfbs for b in e.blobs) / 1e6,
                           "pfbs": len(sq.pfbs), "shares": len(sq.share_bytes()), "data_root": root.hex(),
                           "layout_s": layout_s, "new_dah_from_ods_s": wall_s, "pipeline_ms": pipeline_ms,
                           "gf16_extend_ms": extend_ms, "gf16_int_mm_ms": product_ms,
                           "gf16_share_of_pipeline": extend_ms / pipeline_ms,
                           "gf16_bound_ms": bound_ms, "gf16_bound_by": bound_by, "peak_mib": peak_mib,
                           "base_mib": base_mib, "peak_above_base_mib": peak_mib - base_mib,
                           "host_yardstick_s": host_s}
        kept[k] = {"ods": ods, "eds": ext.squares, "dah": d}
        del ext, host_eds, ods_dev
    return counted, report, kept


def big_repair(dev: torch.device, block: dict) -> tuple[dict, dict]:
    """The k = 256 block: a seeded half of its columns withheld and repaired
    through the 16-bit decode; a flipped parity cell under a blind DAH
    caught as BadEncodingError. Returns (launch counts, report)."""
    honest, d = block["eds"], block["dah"]
    two_k = honest.shape[0]
    k = two_k // 2
    log2_2k = int(math.log2(two_k))
    counted, report = {}, {}
    rng = np.random.default_rng(SEED + 7)
    withheld = np.sort(rng.choice(two_k, size=k, replace=False))
    present = np.ones((two_k, two_k), dtype=bool)
    present[:, withheld] = False
    damaged = np.where(present[..., None], honest, 0).astype(np.uint8)
    rs.repair_axes_cache_clear()
    reset_counts()
    got, report["repair_eds_cold_s"] = timed(lambda: repair.repair_eds(damaged, present, list(d.row_roots),
                                                                        list(d.col_roots)))
    counted["repair"] = read_counts()
    # rows: one pattern, one 16-bit decode, one root reduction; columns: all
    # complete, one codeword check and one root reduction; no K2
    want = {"sha256_compress": 2 * (1 + log2_2k), "rs_extend_lines": 0}
    require(counted["repair"] == want, f"k={k} repair launches {counted['repair']} != {want}")
    require(np.array_equal(got, honest), f"k={k} repair_eds differs from the honest square")
    _, report["repair_eds_warm_s"] = timed(lambda: repair.repair_eds(damaged, present, list(d.row_roots),
                                                                      list(d.col_roots)))
    bad_row, bad_col = int(rng.integers(0, two_k)), int(rng.integers(k + 1, two_k))
    corrupt = honest.copy()
    corrupt[bad_row, bad_col] ^= 0x5A
    reset_counts()
    rows_bad = nmt.eds_axis_roots(corrupt, list(range(two_k)), k)
    cols_bad = nmt.eds_axis_roots(np.swapaxes(corrupt, 0, 1), list(range(two_k)), k)
    counted["blind_dah"] = read_counts()
    require(counted["blind_dah"] == {"sha256_compress": 2 * (1 + log2_2k), "rs_extend_lines": 0},
            f"k={k} blind DAH launches {counted['blind_dah']}")
    require(rows_bad[bad_row].tobytes() == blind_host_root(corrupt, "row", bad_row),
            f"k={k} blind row root differs from the host tree")
    bad_present = np.ones((two_k, two_k), dtype=bool)
    bad_present[bad_row, bad_col] = False
    reset_counts()
    t0 = time.perf_counter()
    try:
        repair.repair_eds(np.where(bad_present[..., None], corrupt, 0).astype(np.uint8), bad_present,
                          [r.tobytes() for r in rows_bad], [c.tobytes() for c in cols_bad])
        raise RuntimeError(f"chip_smoke check failed: the corrupt k={k} square repaired without an error")
    except repair.BadEncodingError as e:
        require((e.axis, e.index) == ("row", bad_row), f"BadEncodingError at {e.axis} {e.index}, not row {bad_row}")
    report["bad_repair_s"] = time.perf_counter() - t0
    counted["bad_repair"] = read_counts()
    require(counted["bad_repair"] == {"sha256_compress": 1 + log2_2k, "rs_extend_lines": 0},
            f"k={k} bad-encoding repair launches {counted['bad_repair']}")
    report["bad_cell"] = [bad_row, bad_col]
    return counted, report


def big_repair_patterns(dev: torch.device, block: dict) -> tuple[dict, dict]:
    """The k = 512 block with BIG_PATTERNS erasure patterns: row r withholds
    a seeded half of the columns, the half of pattern r % BIG_PATTERNS. The
    row sweep decodes BIG_PATTERNS groups and the column sweep checks every
    column whole, so BIG_PATTERNS + 1 RepairAxes of a (32k, 16k) int8
    operand each (128 MiB) pass through the repair cache, which must stay
    within its byte bound. Returns (launch counts, report)."""
    honest, d = block["eds"], block["dah"]
    two_k = honest.shape[0]
    k = two_k // 2
    rng = np.random.default_rng(SEED + 9)
    present = np.ones((two_k, two_k), dtype=bool)
    for p in range(BIG_PATTERNS):
        present[p::BIG_PATTERNS, rng.choice(two_k, size=k, replace=False)] = False
    damaged = np.where(present[..., None], honest, 0).astype(np.uint8)
    rs.repair_axes_cache_clear()
    misses = rs.repair_axes_fn.misses
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    reset_counts()
    got, repair_s = timed(lambda: repair.repair_eds(damaged, present, list(d.row_roots), list(d.col_roots)))
    counted = {"repair_patterns": read_counts()}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    want = {"sha256_compress": 2 * (1 + int(math.log2(two_k))), "rs_extend_lines": 0}
    require(counted["repair_patterns"] == want, f"k={k} {BIG_PATTERNS}-pattern repair launches "
            f"{counted['repair_patterns']} != {want}")
    require(np.array_equal(got, honest), f"k={k} {BIG_PATTERNS}-pattern repair differs from the honest square")
    built = rs.repair_axes_fn.misses - misses
    require(built == BIG_PATTERNS + 1, f"k={k} repair built {built} decode operands, not {BIG_PATTERNS + 1}")
    cache_bytes = rs.repair_axes_cache_nbytes()
    require(cache_bytes <= rs._AXES_FN_MAX_BYTES, f"repair cache holds {cache_bytes} bytes, over its bound")
    rs.repair_axes_cache_clear()
    return counted, {"k": k, "patterns": BIG_PATTERNS, "decode_operands_built": built, "repair_eds_cold_s": repair_s,
                     "cache_mib_after": cache_bytes / 2**20, "cache_bound_mib": rs._AXES_FN_MAX_BYTES / 2**20,
                     "peak_mib": peak_mib, "base_mib": base_mib, "peak_above_base_mib": peak_mib - base_mib}


def plan_blocks(seed: int, n_blocks: int, max_square: int) -> list[square.Square]:
    """B consecutive squares from one seeded candidate list, as
    chain/producer.plan_block_squares plans them: block i is built from
    the candidates that blocks 0..i-1 left."""
    txs, pfbs = realistic_block(seed, max_square, fill=n_blocks + 0.5)
    out = []
    for _ in range(n_blocks):
        sq = square.build(txs, pfbs, max_square, appconsts.SUBTREE_ROOT_THRESHOLD)
        kept_txs, kept_pfbs = {id(t) for t in sq.txs}, {id(e) for e in sq.pfbs}
        left_txs = [t for t in txs if id(t) not in kept_txs]
        left_pfbs = [e for e in pfbs if id(e) not in kept_pfbs]
        require(len(txs) - len(left_txs) == len(sq.txs) and len(pfbs) - len(left_pfbs) == len(sq.pfbs),
                "the planned square's txs are not the candidates' own")
        txs, pfbs = left_txs, left_pfbs
        out.append(sq)
    return out


def check_rs_batched(dev: torch.device, rng: np.random.Generator) -> int:
    """K2 over a batch of squares (2 launches for B squares) against its
    plain version, square by square, at every k <= 128."""
    worst = 0
    for k in K2_CHECK_KS:
        operand = rs.bit_operand(k, dev)
        for b in K2_BATCH_CHECK_BS:
            ods = torch.from_numpy(rng.integers(0, 256, (b, k, k, appconsts.SHARE_SIZE), dtype=np.uint8)).to(dev)
            if k == rs_kernel.MAX_K and b == K2_BATCH_CHECK_BS[-1]:
                ods[-1] = 0xFF  # every s32 sum at its largest
            got = rs.extend_square_fn(k, dev)(ods)
            want = torch.stack([extend_plain(o, operand) for o in ods])
            torch.cuda.synchronize()
            err = max_abs_err(got, want, 0xFF)
            require(err == 0, f"batched K2 differs from its plain version at k={k} B={b}")
            worst = max(worst, err)
    emit("k2_batched_check", ks=list(K2_CHECK_KS), batches=list(K2_BATCH_CHECK_BS), max_abs_err=worst)
    return worst


def batched_blocks(dev: torch.device) -> tuple[dict, dict, list]:
    """B planned k = 128 squares through compute_entries_batched in one
    dispatch. Returns (launch counts, report, (entries, ODSs))."""
    plan, plan_s = timed(lambda: plan_blocks(SEED + 20, BATCH_BLOCKS, appconsts.SQUARE_SIZE_UPPER_BOUND))
    require(all(sq.size == K_MAIN for sq in plan), f"planned sizes {[sq.size for sq in plan]}")
    odss = np.stack([dah.shares_to_ods(sq.share_bytes()) for sq in plan])
    reset_counts()
    entries, dispatch_s = timed(lambda: mesh_engine.compute_entries_batched(odss))
    counted = {"batched": read_counts()}
    want = {"sha256_compress": 2 + 2 * int(math.log2(2 * K_MAIN)) + 1,
            "rs_extend_lines": 0 if leopard.uses_gf16(K_MAIN) else 2}
    require(counted["batched"] == want, f"batched launches {counted['batched']} != {want}")
    for i, (entry, ods) in enumerate(zip(entries, odss)):
        single = bytes(eds.pipeline(ods)[3].cpu().numpy())
        require(entry.data_root == single == entry.dah.hash(), f"batched block {i} differs from one pipeline call")
    card = torch.from_numpy(odss).to(dev)
    per_block = {f"B{b}": cuda_ms(lambda: eds.pipeline_batched(card[:b], dev), reps=5) / b for b in (1, BATCH_BLOCKS)}
    extend = rs.extend_square_fn(K_MAIN, dev)
    k2_per_block = {f"B{b}": cuda_ms(lambda: extend(card[:b]), reps=10) / b for b in (1, BATCH_BLOCKS)}
    report = {"blocks": BATCH_BLOCKS, "plan_s": plan_s, "dispatch_s": dispatch_s,
              "pfbs": [len(sq.pfbs) for sq in plan], "ms_per_block": per_block,
              "k2_extend_ms_per_block": k2_per_block, "k2_extend_bound_ms_per_block": 3 * rs_pass_bound_ms(K_MAIN)[0]}
    return counted, report, (entries, odss)


def device_entry_plane(dev: torch.device, entry, ods: np.ndarray) -> tuple[dict, dict]:
    """A DeviceEntry of the batch: warm() on the card with no crossing, the
    first share proof with one eds and one levels crossing, proofs and
    namespace reads equal to an EdsCacheEntry of the same block."""
    k = entry.k
    before = edscache.crossings()

    def crossed() -> dict:
        now = edscache.crossings()
        return {key: now[key] - before[key] for key in before}

    reset_counts()
    _, warm_s = timed(entry.warm)
    counted = {"warm": read_counts()}
    require(counted["warm"] == {"sha256_compress": 2 * (1 + int(math.log2(2 * k))), "rs_extend_lines": 0},
            f"warm launches {counted['warm']}")
    require(crossed()["host_crossings"] == 0, f"warm() crossed to the host: {crossed()}")
    ns0 = ods[0, 0, :appconsts.NAMESPACE_SIZE].tobytes()
    (prover, first), first_s = timed(lambda: (lambda p: (p, p.prove_shares(0, k, ns0)))(entry.get_prover()))
    after_first = crossed()
    require(after_first == {"host_crossings": 2, "host_crossings.eds": 1, "host_crossings.levels": 1,
                            "host_crossings.col_levels": 0}, f"first share proof crossings {after_first}")
    host_entry = edscache.compute_entry(ods)
    host_prover = host_entry.get_prover()
    for lo, hi in ((0, k), (k * k // 2, k * k // 2 + 3), (k * k - 1, k * k)):
        ns = ods[lo // k, lo % k, :appconsts.NAMESPACE_SIZE].tobytes()
        require(dataclasses.astuple(prover.prove_shares(lo, hi, ns))
                == dataclasses.astuple(host_prover.prove_shares(lo, hi, ns)),
                f"DeviceEntry share proof [{lo}, {hi}) differs from the EdsCacheEntry's")
    col, host_col = entry.get_col_prover(), host_entry.get_col_prover()
    for r, c in ((0, 0), (2 * k - 1, 0), (k, 2 * k - 1)):
        require(dataclasses.astuple(col.prove_cell(c, r)[1]) == dataclasses.astuple(host_col.prove_cell(c, r)[1]),
                f"DeviceEntry column proof of ({r}, {c}) differs")
    present = sorted({ods[r, c, :appconsts.NAMESPACE_SIZE].tobytes() for r in range(k) for c in range(k)})
    queries = present + [bytes(appconsts.NAMESPACE_SIZE)]
    reads = namespace_device.get_namespace_data_batched(entry, queries)
    want_reads = namespace_device.get_namespace_data_batched(host_prover, queries)
    require([dataclasses.astuple(r) for r in reads] == [dataclasses.astuple(r) for r in want_reads],
            "DeviceEntry namespace reads differ from the EdsCacheEntry's")
    final = crossed()
    require(final == {"host_crossings": 3, "host_crossings.eds": 1, "host_crossings.levels": 1,
                      "host_crossings.col_levels": 1}, f"DeviceEntry crossings {final}")
    return counted, {"warm_s": warm_s, "first_proof_s": first_s, "crossings_after_warm": 0,
                     "crossings_after_first_proof": after_first, "crossings_final": final,
                     "namespace_reads": len(queries)}


def stream_run(dev: torch.device, k: int, n: int) -> tuple[dict, dict]:
    """n seeded blocks of size k through stream_blocks with square.build as
    the layout, against the serial run. Returns (launch counts, report)."""
    if k <= appconsts.SQUARE_SIZE_UPPER_BOUND:
        mempools = [realistic_block(SEED + 40 + i, k) for i in range(n)]
        max_square = k
    else:
        mempools = [big_block(SEED + 40 + i, dict(BIG_BLOCKS)[k]) for i in range(n)]
        max_square = BIG_SQUARE_MAX

    def layout(i: int) -> np.ndarray:
        txs, pfbs = mempools[i]
        sq = square.build(txs, pfbs, max_square, appconsts.SUBTREE_ROOT_THRESHOLD)
        require(sq.size == k, f"stream block {i} built k={sq.size}, not {k}")
        return dah.shares_to_ods(sq.share_bytes())

    layouts, layout_s = timed(lambda: [layout(i) for i in range(n)])
    serial, card_s = timed(lambda: [bytes(eds.pipeline(o)[3].cpu().numpy()) for o in layouts])
    del layouts
    streaming.stream_blocks(layout, 2, k)  # first-use set-up (the copy stream, pinned memory) out of the timing
    before = dict(streaming.counters)
    reset_counts()
    roots, streamed_s = timed(lambda: streaming.stream_blocks(layout, n, k))
    counted = read_counts()
    log2_2k = int(math.log2(2 * k))
    per_block = {"sha256_compress": 2 + 2 * log2_2k + 1, "rs_extend_lines": 0 if leopard.uses_gf16(k) else 2}
    require(counted == {name: n * c for name, c in per_block.items()}, f"k={k} streaming launches {counted}")
    require(roots == serial, f"k={k} streamed data roots differ from the serial run")
    moved = {key: streaming.counters[key] - before[key] for key in (
        "streaming.overlap_stalls", "streaming.fetches", "streaming.fetch_s", "streaming.layout_s",
        "streaming.queue_s")}
    profile = device_profile(f"stream_profile_k{k}", lambda: streaming.stream_blocks(layout, n, k),
                             streamed_s * 1e3, reps=1)
    return counted, {"blocks": n, "blocks_per_s": n / streamed_s, "streamed_s": streamed_s,
                     "serial_layout_s": layout_s, "serial_card_s": card_s, "serial_sum_s": layout_s + card_s,
                     "overlap_stalls": moved["streaming.overlap_stalls"], "fetches": moved["streaming.fetches"],
                     "fetch_wait_s": moved["streaming.fetch_s"], "loop_layout_s": moved["streaming.layout_s"],
                     "loop_queue_s": moved["streaming.queue_s"],
                     "max_blocks_in_flight": streaming.counters["streaming.max_blocks_in_flight"],
                     "blocks_in_flight_after": streaming.counters["streaming.blocks_in_flight"],
                     "card_idle_share": profile["idle_share"], "h2d_copies_per_run": profile["h2d_copies_per_call"]}


def sync_free(dev: torch.device, ods: np.ndarray) -> bool | str:
    """Whether eds.pipeline on an ODS already on the card queues with no
    synchronising call (torch.cuda.set_sync_debug_mode("error") raises on
    one): the property the streaming overlap rests on."""
    card = torch.from_numpy(ods.copy()).to(dev)
    eds.pipeline(card, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eds.pipeline(card, dev)
        return True
    except RuntimeError as e:
        return str(e)[:200]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def scale_plane(dev: torch.device, main: dict, rng: np.random.Generator) -> tuple[dict, int]:
    """Big squares (k = 256 and 512 in GF(2^16)), the k = 256 repair, B
    batched k = 128 blocks in one dispatch, a DeviceEntry, and one-card
    streaming at k = 128 and 256. Returns (launch counts by path, K2's
    largest error in the batched check)."""
    t0 = time.perf_counter()
    big_counts, big_report, kept = big_blocks(dev)
    repair_counts, repair_report = big_repair(dev, kept[BIG_REPAIR_K])
    pattern_counts, pattern_report = big_repair_patterns(dev, kept[BIG_PATTERN_K])
    sync = {k: sync_free(dev, o) for k, o in ((K_MAIN, main["ods"]), (BIG_REPAIR_K, kept[BIG_REPAIR_K]["ods"]))}
    require(all(v is True for v in sync.values()), f"eds.pipeline synchronises with the host: {sync}")
    del kept
    big_s = time.perf_counter() - t0
    k2_err = check_rs_batched(dev, rng)
    batch_counts, batch_report, (entries, odss) = batched_blocks(dev)
    entry_counts, entry_report = device_entry_plane(dev, entries[0], odss[0])
    del entries
    stream_counts, stream_report = {}, {}
    for k, n in STREAM_BLOCKS:
        stream_counts[f"k{k}"], stream_report[f"k{k}"] = stream_run(dev, k, n)
    # the ported benches on synthetic layouts (each checks its own roots)
    stream_report["bench_stream"] = streaming.bench_stream(k=BIG_REPAIR_K, n_blocks=4)
    stream_report["bench_stream_batched"] = streaming.bench_stream_batched(k=K_MAIN, batch=BATCH_BLOCKS, n_batches=3)

    def total(counts: dict) -> dict:
        return {name: sum(c[name] for c in counts.values()) for name in ("sha256_compress", "rs_extend_lines")}

    # free the 16-bit operands this phase cached, so that the block's peak
    # memory in `timings` counts what it counted before this phase
    rs.bit_operand16.cache_clear()
    rs.repair_axes_cache_clear()
    torch.cuda.empty_cache()
    emit("scale_plane", big_blocks=big_report, big_launches=big_counts, repair_k256=repair_report,
         repair_launches=repair_counts, repair_patterns=pattern_report, repair_patterns_launches=pattern_counts,
         batched=batch_report, batched_launches=batch_counts,
         device_entry=entry_report, device_entry_launches=entry_counts, streaming=stream_report,
         streaming_launches=stream_counts, sync_free_pipeline=sync, big_and_repair_s=big_s,
         seconds=time.perf_counter() - t0)
    return {"scale": total({**big_counts, **repair_counts, **pattern_counts}), "batched": total({**batch_counts, **entry_counts}),
            "streaming": total(stream_counts)}, k2_err


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
    base_mib = torch.cuda.memory_allocated() / 2**20
    dah.new_dah_from_ods(ods_np)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    emit("block_time", k=k, pipeline_ms=block_ms, new_dah_from_ods_ms=dah_ms, peak_mib=peak_mib, base_mib=base_mib)
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
    adm = admission_plane(dev, main)
    by_path["admission_plane"] = adm["admission"]
    by_path.update(node_plane(dev, adm["honest_raws"]))
    by_path["consensus_plane"] = consensus_plane(dev, adm["honest_raws"])
    by_path["network_plane"], by_path["light_plane"] = network_plane(dev, adm["honest_raws"])
    by_path["scenario_plane"] = scenario_plane(dev)
    by_path["cli"] = cli_plane(dev)
    by_path["mesh_plane"] = mesh_plane(dev, adm["honest_raws"])
    codec_counts = codec_plane(dev, main)
    by_path["codec_plane"] = {name: sum(c[name] for c in codec_counts.values())
                              for name in ("sha256_compress", "rs_extend_lines")}
    scale_counts, k2_batched_err = scale_plane(dev, main, rng)
    by_path.update(scale_counts)
    k2_err = max(k2_err, k2_batched_err)
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
