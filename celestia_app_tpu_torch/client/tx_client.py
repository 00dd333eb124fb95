"""Programmatic tx submission: Signer + TxClient.

Port of celestia_app_tpu/client/tx_client.py. Reference parity: pkg/user —
`Signer` (multi-account sequence tracking, signer.go:23-35), `TxClient`
(gas estimation, fee calc, broadcast, ConfirmTx, sequence-mismatch
resubmission, tx_client.go:87-104,202-250,320-420). The transport is an
in-process Node or `HttpNodeClient` over the node service's JSON routes
(service/server.py); the resubmission loop mirrors
app/errors/nonce_mismatch.go by parsing the expected sequence out of the
ante error string. The gRPC transport (`GrpcNodeClient`,
`setup_tx_client_grpc`) is not ported.
"""

from __future__ import annotations

import dataclasses
import re

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch.chain import modules
from celestia_app_tpu_torch.chain.crypto import PrivateKey
from celestia_app_tpu_torch.chain.tx import MsgPayForBlobs, MsgSend, TxBody, sign_tx
from celestia_app_tpu_torch.da import blob as blob_mod
from celestia_app_tpu_torch.da import commitment as commitment_mod
from celestia_app_tpu_torch.da.blob import Blob
from celestia_app_tpu_torch.utils import telemetry

_SEQ_RE = re.compile(r"expected (\d+), got (\d+)")
_GAS_PRICE_RE = re.compile(r"insufficient gas price: [0-9.]+ < min ([0-9.]+)")


def parse_expected_sequence(err: str) -> int | None:
    """app/errors/nonce_mismatch.go:13-30 equivalent."""
    m = _SEQ_RE.search(err)
    return int(m.group(1)) if m else None


def parse_required_min_gas_price(err: str) -> float | None:
    """app/errors/insufficient_gas_price.go analog: the gas-price floor the
    node demands, parsed from the ante rejection (chain/ante.py step 4) so
    the client can re-price and resubmit instead of failing the user."""
    m = _GAS_PRICE_RE.search(err)
    return float(m.group(1)) if m else None


@dataclasses.dataclass
class Account:
    priv: PrivateKey
    number: int
    sequence: int

    @property
    def address(self) -> bytes:
        return self.priv.public_key().address()


class Signer:
    """Tracks account numbers/sequences and signs tx bodies (pkg/user Signer).

    `wire="proto"` (default) produces cosmos TxRaw bytes with
    SIGN_MODE_DIRECT sign docs — what the reference's pkg/user/signer.go
    emits; `wire="native"` keeps the framework's legacy codec."""

    def __init__(self, chain_id: str, wire: str = "proto"):
        self.chain_id = chain_id
        self.wire = wire
        self.accounts: dict[bytes, Account] = {}

    def add_account(self, priv: PrivateKey, number: int, sequence: int = 0) -> bytes:
        acc = Account(priv, number, sequence)
        self.accounts[acc.address] = acc
        return acc.address

    def create_tx(self, addr: bytes, msgs, fee: int, gas_limit: int, memo: str = ""):
        acc = self.accounts[addr]
        body = TxBody(
            msgs=tuple(msgs),
            chain_id=self.chain_id,
            account_number=acc.number,
            sequence=acc.sequence,
            fee=fee,
            gas_limit=gas_limit,
            memo=memo,
        )
        if self.wire == "proto":
            from celestia_app_tpu_torch.wire import codec as wire_codec

            return wire_codec.sign_tx_proto(body, acc.priv)
        return sign_tx(body, acc.priv)

    def build_pfb_msg(
        self, addr: bytes, blobs: list[Blob], subtree_root_threshold: int = 64
    ) -> MsgPayForBlobs:
        """MsgPayForBlobs with per-blob share commitments — the expensive
        part (Merkle trees over all blob shares); build ONCE and re-sign
        with different fee/gas as needed."""
        return MsgPayForBlobs(
            signer=addr,
            namespaces=tuple(b.namespace.raw for b in blobs),
            blob_sizes=tuple(len(b.data) for b in blobs),
            share_commitments=tuple(
                commitment_mod.create_commitment(b, subtree_root_threshold)
                for b in blobs
            ),
            share_versions=tuple(b.share_version for b in blobs),
        )

    def create_pay_for_blobs(
        self, addr: bytes, blobs: list[Blob], fee: int, gas_limit: int,
        subtree_root_threshold: int = 64, msg: MsgPayForBlobs | None = None,
    ) -> bytes:
        """Build MsgPayForBlobs + sign + wrap in a BlobTx envelope
        (x/blob/types/payforblob.go:48-77 + blob.MarshalBlobTx). Pass a
        precomputed `msg` to skip recomputing commitments."""
        if msg is None:
            msg = self.build_pfb_msg(addr, blobs, subtree_root_threshold)
        tx = self.create_tx(addr, [msg], fee, gas_limit)
        return blob_mod.marshal_blob_tx(tx.encode(), blobs)


class HttpNodeClient:
    """Remote node transport: the same surface TxClient needs, over the
    HTTP JSON service (service/server.py) — the reference's gRPC remote
    mode (pkg/user/tx_client.go:320-330 BroadcastMode_SYNC + Simulate).

    Holds ONE persistent HTTP/1.1 keep-alive connection (the serving
    plane's dasload pattern): a submit-then-poll client issues many
    small requests, and a fresh TCP connect per request dominates the
    round-trip on small blobs under sustained load. A torn socket (idle
    reaper, server restart) reconnects transparently once per request
    (`txclient.reconnects`). One connection, one lock: the client is
    thread-safe but callers wanting concurrency (tools/txsim.py) give
    each sequence its own client."""

    def __init__(self, base_url: str, timeout: float = 30.0):
        import threading
        import urllib.parse

        self.base_url = base_url.rstrip("/")
        p = urllib.parse.urlparse(self.base_url)
        self._host = p.hostname
        self._port = p.port or (443 if p.scheme == "https" else 80)
        self._tls = p.scheme == "https"
        self.timeout = timeout
        self._lock = threading.Lock()
        self._conn = None  # guarded-by: _lock

    def _new_conn(self):
        import http.client

        if self._tls:
            return http.client.HTTPSConnection(self._host, self._port,
                                               timeout=self.timeout)
        return http.client.HTTPConnection(self._host, self._port,
                                          timeout=self.timeout)

    def _request(self, method: str, path: str,
                 payload: dict | None = None) -> dict:
        import http.client
        import json as json_mod

        body = None
        headers = {}
        if payload is not None:
            body = json_mod.dumps(payload).encode()
            headers["Content-Type"] = "application/json"
        # one keep-alive connection IS the serialization point: HTTP/1.1
        # cannot multiplex, so requests must queue on the client's own
        # lock (callers wanting concurrency hold one client per
        # sequence); no node/service lock is ever involved
        with self._lock:  # lint: disable=blocking-under-lock
            for attempt in (0, 1):
                if self._conn is None:
                    self._conn = self._new_conn()
                    if attempt:
                        telemetry.incr("txclient.reconnects")
                try:
                    self._conn.request(method, path, body=body,
                                       headers=headers)
                    r = self._conn.getresponse()
                    data = r.read()
                    status = r.status
                    break
                except (OSError, http.client.HTTPException):
                    # keep-alive races are normal: one clean reconnect
                    try:
                        self._conn.close()
                    finally:
                        self._conn = None
                    if attempt:
                        raise
        try:
            out = json_mod.loads(data)
        except ValueError:
            out = {"error": data.decode("utf-8", "replace")}
        if status >= 400:
            # OSError family, like the urllib HTTPError the PeerClient
            # transport used to raise — existing callers (cli das --url)
            # catch OSError to degrade gracefully
            raise OSError(
                f"{method} {path} -> {status}: {out.get('error', out)}")
        return out

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                finally:
                    self._conn = None

    def _post(self, path: str, payload: dict) -> dict:
        return self._request("POST", path, payload)

    def broadcast_tx(self, raw: bytes):
        import base64

        out = self._post("/broadcast_tx", {"tx": base64.b64encode(raw).decode()})
        from celestia_app_tpu_torch.chain.block import TxResult

        return TxResult(out["code"], out.get("log", ""),
                        out.get("gas_wanted", 0), out.get("gas_used", 0), [])

    def simulate_tx(self, raw: bytes) -> int:
        """-> gas_used; raises on a failed simulation."""
        import base64

        out = self._post("/simulate_tx", {"tx": base64.b64encode(raw).decode()})
        if out["code"] != 0:
            raise RuntimeError(f"simulation failed: {out.get('log')}")
        return out["gas_used"]

    def confirm_tx(
        self, raw: bytes, attempts: int = 1, interval: float = 3.0
    ) -> dict:
        """Poll the tx-by-hash route until found or attempts run out —
        {'found': bool, height?, index?}. The reference's ConfirmTx polls
        every 3s (tx_client.go:412); the server's own block loop (`start`)
        or a devnet /produce_block commits the tx between polls."""
        import hashlib
        import time as time_mod

        txhash = hashlib.sha256(raw).hexdigest()
        for i in range(max(1, attempts)):
            out = self._post("/abci_query", {"path": "tx", "data": {"hash": txhash}})
            if out.get("found"):
                return out
            if i + 1 < attempts:
                time_mod.sleep(interval)
        return out

    def status(self) -> dict:
        return self._request("GET", "/status")


class TxClient:
    """High-level submission against an in-process Node OR a remote
    transport (HttpNodeClient — both expose broadcast_tx/confirm_tx; gas
    estimation prefers true simulation when the transport offers it)."""

    def __init__(self, node, signer: Signer, gas_multiplier: float = 1.1,
                 default_gas_price: float | None = None):
        self.node = node
        self.signer = signer
        self.gas_multiplier = gas_multiplier
        self.default_gas_price = default_gas_price

    def _gas_price(self) -> float:
        if self.default_gas_price is not None:
            return self.default_gas_price
        return max(
            appconsts.DEFAULT_MIN_GAS_PRICE,
            appconsts.DEFAULT_NETWORK_MIN_GAS_PRICE,
        )

    def _simulate_gas(self, raw: bytes) -> int | None:
        """Simulate-based estimation (tx_client.go estimateGas): dry-run the
        tx and return measured gas, or None when no simulator is reachable
        (fall back to the linear model)."""
        sim = getattr(self.node, "simulate_tx", None)
        if sim is None:
            app = getattr(self.node, "app", None)
            sim = getattr(app, "simulate_tx", None)
        if sim is None:
            return None
        try:
            res = sim(raw)
        except Exception:
            # unreachable/failing simulator (HTTP errors, bad body, failed
            # simulation): fall back to the linear model as documented
            telemetry.incr("txclient.sim_fallback")
            return None
        if isinstance(res, int):
            return res
        return res.gas_used if res.code == 0 else None

    def estimate_gas(
        self, addr: bytes, msgs, blobs: list[Blob] | None = None, pfb_msg=None
    ) -> int:
        """Measured-gas estimation with the linear PFB model as fallback.
        Pass `pfb_msg` (from Signer.build_pfb_msg) to avoid recomputing
        blob commitments for the probe."""
        if blobs:
            probe = self.signer.create_pay_for_blobs(
                addr, blobs, fee=1, gas_limit=1 << 40, msg=pfb_msg
            )
        else:
            probe = self.signer.create_tx(addr, msgs, fee=1, gas_limit=1 << 40).encode()
        measured = self._simulate_gas(probe)
        if measured is not None:
            return int(measured * self.gas_multiplier)
        if blobs:
            return int(
                modules.estimate_pfb_gas([len(b.data) for b in blobs])
                * self.gas_multiplier
            )
        return 100_000

    def _recover_broadcast_failure(self, addr: bytes, res, gas: int,
                                   fee: int) -> int | None:
        """Shared resubmission logic (tx_client.go:330-360 + app/errors):
        a sequence mismatch resyncs the signer; an insufficient-gas-price
        rejection re-prices against the node's parsed floor. Returns the
        new fee to retry with, or None when the failure is terminal."""
        expected = parse_expected_sequence(res.log)
        if expected is not None:
            self.signer.accounts[addr].sequence = expected
            return fee
        floor = parse_required_min_gas_price(res.log)
        if floor is not None:
            # remember the node's floor: only the FIRST underpriced tx pays
            # the extra rejected round-trip
            self.default_gas_price = max(self._gas_price(), floor)
            return max(fee + 1, int(gas * floor) + 1)
        return None

    def _broadcast_with_retry(self, addr: bytes, make_raw, gas: int,
                              fee: int):
        """THE submit loop every submit_* goes through. 3 attempts: the two
        recoverable rejection classes (stale sequence, price below floor —
        tx_client.go:357 + app/errors parsing) can BOTH occur on one tx,
        each burning one attempt. `make_raw(fee)` re-signs with the
        current fee/sequence. On acceptance, bumps the cached sequence and
        confirms — the in-process Node drives blocks to commit and returns
        (height, TxResult); remote transports POLL the server's block
        production and return the tx-by-hash dict (check ['found'])."""
        for _attempt in range(3):
            raw = make_raw(fee)
            res = self.node.broadcast_tx(raw)
            if res.code == 0:
                self.signer.accounts[addr].sequence += 1
                if isinstance(self.node, HttpNodeClient):
                    return self.node.confirm_tx(raw, attempts=10,
                                                interval=1.0)
                return self.node.confirm_tx(raw)
            new_fee = self._recover_broadcast_failure(addr, res, gas, fee)
            if new_fee is None:
                raise RuntimeError(f"broadcast failed: {res.log}")
            fee = new_fee
        raise RuntimeError(f"resubmission failed; last rejection: {res.log}")

    def submit_pay_for_blob(self, addr: bytes, blobs: list[Blob]):
        """Estimate gas (simulate, falling back to the linear model), sign,
        broadcast, confirm. Blob commitments — the dominant client-side
        hashing cost — are computed exactly once."""
        pfb_msg = self.signer.build_pfb_msg(addr, blobs)
        gas = self.estimate_gas(addr, [], blobs, pfb_msg=pfb_msg)
        fee = max(1, int(gas * self._gas_price()) + 1)
        return self._broadcast_with_retry(
            addr,
            lambda f: self.signer.create_pay_for_blobs(
                addr, blobs, fee=f, gas_limit=gas, msg=pfb_msg
            ),
            gas, fee,
        )

    def submit_create_validator(self, addr: bytes, self_stake: int,
                                pubkey: bytes = b""):
        """MsgCreateValidator with the consensus pubkey registered on-chain
        (the reference tx staking create-validator; pubkey is what lets
        the new validator's votes verify — chain/reactor.py)."""
        from celestia_app_tpu_torch.chain.tx import MsgCreateValidator

        gas = 200_000
        fee = max(1, int(gas * self._gas_price()) + 1)
        return self._broadcast_with_retry(
            addr,
            lambda f: self.signer.create_tx(
                addr, [MsgCreateValidator(addr, self_stake, pubkey)],
                fee=f, gas_limit=gas,
            ).encode(),
            gas, fee,
        )

    def submit_send(self, addr: bytes, to: bytes, amount: int):
        gas = 100_000
        fee = max(1, int(gas * self._gas_price()) + 1)
        return self._broadcast_with_retry(
            addr,
            lambda f: self.signer.create_tx(
                addr, [MsgSend(addr, to, amount)], fee=f, gas_limit=gas
            ).encode(),
            gas, fee,
        )
