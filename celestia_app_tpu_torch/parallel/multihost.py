"""Multi-host: the sharded block pipeline across OS processes. The port of
celestia_app_tpu/parallel/multihost.py.

N worker processes ("hosts") hold M seq shards each, all on the host's own
device (``--device``: cuda, or cpu). Together they form one global (data,
seq) mesh of N x M shards, factored as parallel/mesh.factor factors
devices; shard g = d * seq + s lives on host g // M. Each host

- reads only its own rows of the seeded workload (``default_rng(1234)``,
  (B, k, k, 512)) and uploads them (ledger site ``multihost.dispatch``);
- runs the steps of parallel/sharded_eds.py on its shards: row pass (K2),
  transpose 1, column pass (K2), column leaves hashed once and column
  roots (K1), transpose 2 with shares and digests packed together, row
  roots (K1), and counts the kernel launches its pipeline made (a card's
  wrappers count CUDA launches only);
- makes each transpose from intra-host copies between its own shards plus
  one cross-host ``torch.distributed.all_to_all_single`` over gloo on host
  tensors (the reference's DCN stand-in is gloo too), the pieces crossing
  the card boundary under the ledger site ``multihost.exchange``;
- gathers every host's axis roots (``all_gather``, site
  ``multihost.roots``) and computes the data roots of the whole batch;
- checks them against the single-host oracle: `da/eds.pipeline` of each
  block of the same workload, on its own device.

`spawn_dryrun` starts the hosts as ``python -m celestia_app_tpu_torch
multihost-worker`` processes (from the directory that holds the package;
on a card the kernels are built once in the parent first, so two workers
never build into one directory) and aggregates their verdicts into one
JSON-able dict. The process group gets its address, world size and rank
from the command line: nothing is read from the environment.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.da import eds as eds_mod
from celestia_app_tpu_torch.obs import xfer
from celestia_app_tpu_torch.ops import merkle, rs_kernel, sha256_kernel
from celestia_app_tpu_torch.parallel import mesh as mesh_mod
from celestia_app_tpu_torch.parallel import sharded_eds

SHARE = appconsts.SHARE_SIZE


class _Host:
    """One host's view of the global mesh: its own shards and the plan of
    the cross-host exchanges."""

    def __init__(self, rank: int, n_hosts: int, per_host: int, k: int, batch: int, dev: torch.device):
        self.rank, self.n_hosts, self.per_host, self.k, self.dev = rank, n_hosts, per_host, k, dev
        self.n_data, self.seq = mesh_mod.factor(n_hosts * per_host, k)
        if batch % self.n_data:
            raise ValueError(f"batch {batch} must divide over data axis {self.n_data}")
        self.b_l, self.r_l, self.c_l = batch // self.n_data, k // self.seq, 2 * k // self.seq
        self.own = list(range(rank * per_host, (rank + 1) * per_host))
        self.exchanged = 0

    def shards_of(self, host: int) -> list[int]:
        return list(range(host * self.per_host, (host + 1) * self.per_host))

    def exchange(self, srcs: dict, dsts: dict) -> None:
        """The cross-host part of a transpose (parallel/sharded_eds.
        transpose, which copies the pairs of this host's own shards): every
        piece between a shard here and one of another host crosses in one
        all_to_all_single over gloo on host tensors. `srcs` and `dsts` map
        this host's (d, s) to its shards."""
        if self.n_hosts == 1:
            return
        width = next(iter(dsts.values())).shape[1]
        shape = sharded_eds.piece(next(iter(srcs.values())), 0, width).shape
        piece_n = int(np.prod(shape))
        send, in_splits, out_splits = [], [], []
        for q in range(self.n_hosts):
            sent = received = 0
            if q != self.rank:
                for g in self.shards_of(q):  # their shards, ours in their row
                    d, s = divmod(g, self.seq)
                    for (d2, s2), src in srcs.items():
                        if d2 == d:
                            send.append(sharded_eds.piece(src, s, width).reshape(-1))
                            sent += piece_n
                for d, _ in dsts:  # our shards, theirs in our row
                    received += piece_n * sum(1 for g2 in self.shards_of(q) if g2 // self.seq == d)
            in_splits.append(sent)
            out_splits.append(received)
        out = torch.cat(send) if send else torch.empty(0, dtype=torch.uint8, device=self.dev)
        out_h = torch.from_numpy(xfer.to_host(out, "multihost.exchange"))
        in_h = torch.empty(sum(out_splits), dtype=torch.uint8)
        dist.all_to_all_single(in_h, out_h, out_splits, in_splits)
        self.exchanged += out_h.numel() + in_h.numel()
        recv = xfer.to_device(in_h, "multihost.exchange", device=self.dev)
        off = 0
        for q in range(self.n_hosts):
            if q == self.rank:
                continue
            for (d, s), dst in dsts.items():
                for g2 in self.shards_of(q):
                    if g2 // self.seq == d:
                        sharded_eds.place(dst, g2 % self.seq, recv[off:off + piece_n].view(shape))
                        off += piece_n


def _workload(k: int, batch: int) -> np.ndarray:
    rng = np.random.default_rng(1234)
    return rng.integers(0, 256, size=(batch, k, k, SHARE), dtype=np.uint8)


def _host_pipeline(h: _Host, global_ods: np.ndarray):
    """The sharded pipeline on this host's shards: the data roots of the
    whole batch, (B, 32) on the host's device."""
    k, two_k, b_l, r_l, c_l, seq, dev = h.k, 2 * h.k, h.b_l, h.r_l, h.c_l, h.seq, h.dev
    own = [divmod(g, seq) for g in h.own]
    tops = {}
    for d, s in own:  # 1. this host's rows only, uploaded and extended
        slab = np.ascontiguousarray(global_ods[d * b_l:(d + 1) * b_l, s * r_l:(s + 1) * r_l])
        tops[d, s] = sharded_eds.row_pass(xfer.to_device(slab, "multihost.dispatch", device=dev), k)
    cols = {g: torch.empty((b_l, c_l, two_k, SHARE), dtype=torch.uint8, device=dev) for g in own}
    sharded_eds.transpose(tops, cols, h.exchange)  # 2. transpose 1
    del tops
    packed, col_roots = {}, {}
    for d, s in own:  # 3, 4. column pass, leaves once, column roots
        col_roots[d, s], packed[d, s] = sharded_eds.column_pass(cols.pop((d, s)), k, s * c_l)
    backs = {g: torch.empty((b_l, c_l, two_k, SHARE + 32), dtype=torch.uint8, device=dev) for g in own}
    sharded_eds.transpose(packed, backs, h.exchange)  # 5. transpose 2
    del packed
    # 6. row roots
    own_roots = [torch.stack([sharded_eds.row_roots_of(backs[d, s], k, s * c_l), col_roots[d, s]])
                 for d, s in own]
    # 7. every host's axis roots, then the data roots of the whole batch
    mine = torch.from_numpy(xfer.to_host(torch.stack(own_roots), "multihost.roots"))
    every = [torch.empty_like(mine) for _ in range(h.n_hosts)]
    dist.all_gather(every, mine)
    batch = h.n_data * b_l
    axis = np.zeros((batch, 2, two_k, appconsts.NMT_ROOT_SIZE), dtype=np.uint8)
    for host, roots in enumerate(every):
        for i, g in enumerate(h.shards_of(host)):
            d, s = divmod(g, seq)
            axis[d * b_l:(d + 1) * b_l, :, s * c_l:(s + 1) * c_l] = roots[i].numpy().transpose(1, 0, 2, 3)
    axis_dev = xfer.to_device(axis.reshape(batch, 2 * two_k, -1), "multihost.roots", device=dev)
    return merkle.merkle_root_pow2(axis_dev)


def worker_main(process_id: int, num_processes: int, coordinator: str, k: int, batch: int,
                devices_per_host: int, device: str = "cpu") -> dict:
    """One host: join the gloo process group at `coordinator`
    (``host:port``), run its shards of the pipeline on `device`, and check
    the data roots against the single-host oracle. Returns its verdict."""
    dev = device_mod.concrete(device_mod.resolve(device))
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=300))
    try:
        h = _Host(process_id, num_processes, devices_per_host, k, batch, dev)
        global_ods = _workload(k, batch)
        dist.barrier()
        k1, k2 = sha256_kernel.compress_words.launches, rs_kernel.extend_lines.launches
        t0 = time.monotonic()
        roots = xfer.to_host(_host_pipeline(h, global_ods), "multihost.roots")
        elapsed = time.monotonic() - t0
        launches = {"sha256_compress": sha256_kernel.compress_words.launches - k1,
                    "rs_extend_lines": rs_kernel.extend_lines.launches - k2}
        oracle = [bytes(xfer.to_host(eds_mod.pipeline(global_ods[i], dev)[3], "multihost.oracle"))
                  for i in range(batch)]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return {
        "process_id": process_id,
        "num_processes": num_processes,
        "global_devices": num_processes * devices_per_host,
        "local_devices": devices_per_host,
        "device": str(dev),
        "mesh": {"data": h.n_data, "seq": h.seq},
        "k": k,
        "batch": batch,
        "pipeline_s": elapsed,
        "exchanged_bytes": h.exchanged,
        "launches": launches,
        "data_roots": [bytes(r).hex() for r in roots],
        "matches_host_oracle": [bytes(r) for r in roots] == oracle,
    }


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(k: int, batch: int, num_processes: int, devices_per_host: int, port: int,
                 timeout_s: float, device: str) -> list[dict]:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs, err_files = [], []
    try:
        for pid in range(num_processes):
            # stderr to a file, not a pipe: a worker blocked on a full pipe
            # would stop taking part in the collectives
            ef = tempfile.NamedTemporaryFile(mode="w+", suffix=f".mh{pid}.err", delete=False)
            err_files.append(ef)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "celestia_app_tpu_torch", "multihost-worker",
                 "--process-id", str(pid), "--num-processes", str(num_processes),
                 "--coordinator", f"127.0.0.1:{port}", "--k", str(k), "--batch", str(batch),
                 "--devices-per-host", str(devices_per_host), "--device", device],
                stdout=subprocess.PIPE, stderr=ef, text=True, cwd=root))
        outs = []
        deadline = time.monotonic() + timeout_s
        for p, ef in zip(procs, err_files):
            out, _ = p.communicate(timeout=max(5.0, deadline - time.monotonic()))
            if p.returncode != 0:
                ef.seek(0)
                raise RuntimeError(f"worker failed rc={p.returncode}: {ef.read()[-800:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for ef in err_files:
            ef.close()
            os.unlink(ef.name)


def spawn_dryrun(k: int = 16, batch: int = 2, num_processes: int = 2, devices_per_host: int = 4,
                 timeout_s: float = 600.0, device: str = "cpu") -> dict:
    """Spawn the hosts and aggregate their verdicts (the driver side of
    ``python -m celestia_app_tpu_torch multihost-dryrun``). Agreement is
    grounded in the oracle: every host recomputes the batch's data roots
    with the one-device pipeline and compares them with the roots the
    global mesh gave it."""
    if num_processes < 1 or devices_per_host < 1:
        raise ValueError("num_processes and devices_per_host must be >= 1")
    if torch.device(device).type == "cuda":
        from celestia_app_tpu_torch import cuda_build

        cuda_build.build()
    for attempt in range(2):  # a free port picked here can be taken before the workers bind it
        try:
            outs = _run_workers(k, batch, num_processes, devices_per_host, _free_port(), timeout_s, device)
            break
        except RuntimeError:
            if attempt:
                raise
    return {
        "num_processes": num_processes,
        "devices_per_host": devices_per_host,
        "global_devices": outs[0]["global_devices"],
        "device": outs[0]["device"],
        "mesh": outs[0]["mesh"],
        "k": k,
        "batch": batch,
        "pipeline_s": max(o["pipeline_s"] for o in outs),
        "exchanged_bytes": sum(o["exchanged_bytes"] for o in outs),
        "host_data_roots": [o["data_roots"] for o in outs],
        "host_launches": [o["launches"] for o in outs],
        "all_hosts_match_oracle": all(o["matches_host_oracle"] for o in outs),
    }
