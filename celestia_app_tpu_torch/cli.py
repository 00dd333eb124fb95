"""celestia-appd-style CLI: init, start, status, query, keys, tools. The
port of celestia_app_tpu/cli.py.

Reference parity: cmd/celestia-appd/cmd/root.go:53-154 assembles the node
commands (init/start/query/keys/rollback) plus the tools/ binaries. Here:

    python -m celestia_app_tpu_torch init  --home DIR --chain-id ID \
        [--account HEXADDR=BALANCE ...] [--validator HEXADDR=POWER ...]
    python -m celestia_app_tpu_torch start --home DIR [--listen PORT] \
        [--block-time SECONDS] [--blocks N]
    python -m celestia_app_tpu_torch status --home DIR
    python -m celestia_app_tpu_torch query --home DIR PATH [JSON_DATA]
    python -m celestia_app_tpu_torch keys derive SEED
    python -m celestia_app_tpu_torch rollback --home DIR HEIGHT
    python -m celestia_app_tpu_torch export --home DIR
    python -m celestia_app_tpu_torch blocktime --home DIR [--last N]
    python -m celestia_app_tpu_torch blockscan --home DIR
    python -m celestia_app_tpu_torch txsim --home DIR [--rounds N ...]
    python -m celestia_app_tpu_torch tx send|pay-for-blob --home DIR --from-seed S ...
    python -m celestia_app_tpu_torch devnet --home DIR [--validators N] [--load]
    python -m celestia_app_tpu_torch snapshot create|restore --home DIR --out DIR

`start` runs the single-process node loop (chain/node.py) with the HTTP
service attached; state persists under --home/data and survives restarts.
`devnet` runs an N-validator consensus network in-process (local_devnet
analog); `snapshot` is verified state-sync for fresh-home bootstrap.

Where the port differs from the reference:

- **Device, not engine.** Every command takes ``--device`` (the card,
  ``cuda``, unless the caller passes ``--device cpu``); without it a
  command with a home runs on the home's ``config.json`` ``device`` key,
  else on the card. A ``cuda`` device on a host with no card raises
  (`_resolve_device`); nothing falls back to the CPU. ``init`` writes
  ``device`` where the reference writes ``engine``; a home that the
  reference wrote has no ``device`` key and opens on the card.
- ``validator-serve``, ``devnet --processes`` and ``e2e-bench`` build the
  CUDA kernels once in the parent (a card device) and pass the parent's
  device to every child they spawn.
- ``validator-serve`` turns SIGTERM into the clean exit it takes on
  Ctrl-C, and on the way out writes one line to stderr
  (`EXIT_LINE_PREFIX` and a JSON object): its device, its K1 and K2
  launch counts, and its peak device memory on a card.
- ``--device mesh`` is the reference's ``--engine mesh``: the card, with
  the mesh plane over every visible card (parallel/mesh_engine.card_mesh);
  ``init`` records ``device: "mesh"``. On a one-card host it runs the
  one-device path, as the reference's mesh engine does on one device.
- ``multihost-dryrun`` spawns ``multihost-worker`` processes joined by a
  gloo process group (parallel/multihost.py), on ``--device``.
- Not ported yet: ``relayer``, ``analyze`` and every ``--grpc`` flag
  (`DEFERRED`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# the reference's commands this port does not carry yet
DEFERRED = ("relayer", "analyze")

# validator-serve's last stderr line: this prefix, then a JSON object
EXIT_LINE_PREFIX = "validator-exit "


def _resolve_device(args) -> str:
    """The device a command runs on: ``--device``, else the ``device`` key
    of the home's config.json, else the card. A card device on a host with
    no card raises (the caller passes ``--device cpu`` for the plain
    path)."""
    import torch

    name = getattr(args, "device", None)
    home = getattr(args, "home", None)
    if name is None and isinstance(home, str):
        try:
            with open(os.path.join(home, "config.json")) as f:
                name = json.load(f).get("device")
        except (OSError, ValueError, AttributeError):
            name = None
    name = name or "cuda"
    if torch.device(_torch_device(name)).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for --device {name}: pass --device cpu to run "
            "the plain path")
    return name


def _torch_device(name: str) -> str:
    """The torch device of a ``--device`` value: ``mesh`` runs on the card."""
    return "cuda" if name == "mesh" else name


def _mesh_of(name: str):
    """The App's ``mesh`` for a ``--device`` value: every visible card for
    ``mesh`` (None on a one-card host), else None."""
    if name != "mesh":
        return None
    from celestia_app_tpu_torch.parallel import mesh_engine

    return mesh_engine.card_mesh()


# Apps opened by _make_app during one cli.main() call; main() closes the
# ones ITS dispatch opened on the way out. A real CLI process exits anyway,
# but in-process callers (tests, tools embedding cli.main) would otherwise
# leak the storage engine's writer flock until GC and wedge the next
# command on the home. Weakrefs: direct _make_app callers (outside main)
# own their app's lifecycle — the registry must not pin those forever.
_OPEN_APPS: list = []  # list[weakref.ref[App]]


def _make_app(home: str, device: str):
    from celestia_app_tpu_torch import appconsts
    from celestia_app_tpu_torch.chain.app import App

    cfg_path = os.path.join(home, "config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    app = App(
        chain_id=cfg["chain_id"],
        app_version=cfg.get("app_version", 1),
        device=_torch_device(device),
        mesh=_mesh_of(device),
        data_dir=os.path.join(home, "data"),
        min_gas_price=cfg.get("min_gas_price", appconsts.DEFAULT_MIN_GAS_PRICE),
        invariant_check_period=cfg.get("invariant_check_period", 0),
        v2_upgrade_height=cfg.get("v2_upgrade_height"),
        upgrade_height_delay=cfg.get("upgrade_height_delay"),
        da_scheme=cfg.get("da_scheme", "rs2d-nmt"),
        pack_keep=cfg.get("pack_keep", 4),
        max_square_size=cfg.get("max_square_size"),
    )
    import weakref

    _OPEN_APPS.append(weakref.ref(app))
    latest = app.db.latest_height()
    if latest is None:
        with open(os.path.join(home, "genesis.json")) as f:
            genesis = json.load(f)
        app.init_chain(genesis)
    else:
        app.load()
    return app, cfg


def _mempool_kwargs(cfg: dict) -> dict:
    """CAT pool knobs from <home>/config.json -> Node(...) kwargs (one
    reader for every command that builds a Node)."""
    from celestia_app_tpu_torch import appconsts

    return {
        "mempool_ttl": cfg.get(
            "mempool_ttl_blocks", appconsts.MEMPOOL_TX_TTL_BLOCKS),
        "mempool_ttl_seconds": cfg.get(
            "mempool_ttl_seconds", appconsts.MEMPOOL_TX_TTL_SECONDS),
        "mempool_max_txs": cfg.get(
            "mempool_max_txs", appconsts.MEMPOOL_MAX_TXS),
        "mempool_max_bytes": cfg.get(
            "mempool_max_pool_bytes", appconsts.MEMPOOL_MAX_POOL_BYTES),
    }


def cmd_init(args) -> int:
    from celestia_app_tpu_torch import appconsts

    os.makedirs(args.home, exist_ok=True)
    accounts = []
    for spec in args.account or []:
        addr, bal = spec.split("=")
        accounts.append({"address": addr, "balance": int(bal)})
    validators = []
    for spec in args.validator or []:
        addr, power = spec.split("=")
        validators.append({"operator": addr, "power": int(power)})
    if not accounts:
        # fund the default txsim/dev key ring (`keys derive 0..9` seeds) so
        # a fresh home is immediately usable — the reference's testnode
        # genesis funds its well-known accounts the same way
        from celestia_app_tpu_torch.chain.crypto import PrivateKey

        for i in range(10):
            pk = PrivateKey.from_seed(str(i).encode())
            accounts.append(
                {
                    "address": pk.public_key().address().hex(),
                    "balance": 10**12,  # 1M TIA
                }
            )
    if not validators:
        validators.append({"operator": accounts[0]["address"], "power": 10})
    genesis = {
        "time_unix": time.time(),
        "accounts": accounts,
        "validators": validators,
    }
    with open(os.path.join(args.home, "genesis.json"), "w") as f:
        json.dump(genesis, f, indent=2)
    _write_config(args.home, args.chain_id, device=args.device)
    print(f"initialized {args.home} (chain-id {args.chain_id})")
    return 0


def _load_genesis(home: str) -> dict:
    with open(os.path.join(home, "genesis.json")) as f:
        return json.load(f)


def _store_genesis(home: str, genesis: dict) -> None:
    with open(os.path.join(home, "genesis.json"), "w") as f:
        json.dump(genesis, f, indent=2)


def _gentx_sign_doc(doc: dict) -> bytes:
    """Canonical bytes covered by a gentx signature (everything but the
    signature field, sorted-key JSON — the same canonicalization the vote
    and header sign-docs use)."""
    unsigned = {k: v for k, v in doc.items() if k != "signature"}
    return json.dumps(unsigned, sort_keys=True, separators=(",", ":")).encode()


def cmd_genesis_add_account(args) -> int:
    """genutil AddGenesisAccountCmd analog (ref cmd/root.go:130): append a
    funded account to an un-started chain's genesis."""
    genesis = _load_genesis(args.home)
    addr = args.address.lower()
    try:
        if len(bytes.fromhex(addr)) != 20:
            print(f"address {addr!r} is not 20 bytes", file=sys.stderr)
            return 1
    except ValueError:
        print(f"address {addr!r} is not hex", file=sys.stderr)
        return 1
    if int(args.balance) < 0:
        print("balance must be non-negative", file=sys.stderr)
        return 1
    if any(a["address"].lower() == addr for a in genesis.get("accounts", [])):
        print(f"account {addr} already in genesis", file=sys.stderr)
        return 1
    genesis.setdefault("accounts", []).append(
        {"address": addr, "balance": int(args.balance)}
    )
    _store_genesis(args.home, genesis)
    print(f"added {addr} with balance {args.balance}")
    return 0


def cmd_genesis_gentx(args) -> int:
    """genutil GenTxCmd analog (ref cmd/root.go:132): emit a signed
    validator-candidacy document into <home>/gentx/ for collect-gentxs to
    verify and merge. The reference wraps a MsgCreateValidator in a tx;
    the same roles here are (operator, power, pubkey) + signature."""
    from celestia_app_tpu_torch.chain.crypto import PrivateKey

    priv = PrivateKey.from_seed(args.seed.encode())
    pub = priv.public_key()
    doc = {
        "moniker": args.moniker,
        "operator": pub.address().hex(),
        "power": int(args.power),
        "pubkey": pub.compressed.hex(),
    }
    doc["signature"] = priv.sign(_gentx_sign_doc(doc)).hex()
    gdir = os.path.join(args.home, "gentx")
    os.makedirs(gdir, exist_ok=True)
    path = os.path.join(gdir, f"gentx-{doc['operator'][:16]}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"wrote {path}")
    return 0


def cmd_genesis_collect(args) -> int:
    """genutil CollectGenTxsCmd analog (ref cmd/root.go:128): verify every
    gentx in <home>/gentx/ (signature against its own pubkey, operator ==
    address(pubkey), operator funded in genesis) and merge them into the
    genesis validator set."""
    import glob as glob_mod

    from celestia_app_tpu_torch.chain.crypto import PublicKey

    genesis = _load_genesis(args.home)
    funded = {a["address"].lower() for a in genesis.get("accounts", [])}
    validators = {
        v["operator"].lower(): v for v in genesis.get("validators", [])
    }
    n_merged = 0
    merged_ops: set[str] = set()
    for path in sorted(glob_mod.glob(os.path.join(args.home, "gentx", "*.json"))):
        # a gentx file is UNTRUSTED input: any malformed field gets the
        # same "<path>: reason" treatment as a failed signature, never a
        # traceback
        try:
            with open(path) as f:
                doc = json.load(f)
            pub = PublicKey(bytes.fromhex(doc["pubkey"]))
            operator = str(doc["operator"]).lower()
            signature = bytes.fromhex(doc["signature"])
            power = int(doc["power"])
        except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
            print(f"{path}: malformed gentx ({type(e).__name__}: {e})",
                  file=sys.stderr)
            return 1
        if operator != pub.address().hex():
            print(f"{path}: operator does not match pubkey", file=sys.stderr)
            return 1
        if not pub.verify(signature, _gentx_sign_doc(doc)):
            print(f"{path}: bad signature", file=sys.stderr)
            return 1
        if operator not in funded:
            print(f"{path}: operator {operator} has no genesis "
                  "account (add-account first)", file=sys.stderr)
            return 1
        if power <= 0:
            print(f"{path}: non-positive power", file=sys.stderr)
            return 1
        if operator in merged_ops:
            print(f"{path}: duplicate gentx for operator {operator} "
                  "(delete the stale file)", file=sys.stderr)
            return 1
        merged_ops.add(operator)
        validators[operator] = {
            "operator": operator,
            "power": power,
            "pubkey": doc["pubkey"],
        }
        n_merged += 1
    genesis["validators"] = list(validators.values())
    _store_genesis(args.home, genesis)
    print(f"collected {n_merged} gentx(s); validator set size "
          f"{len(genesis['validators'])}")
    return 0


def cmd_genesis_validate(args) -> int:
    """genutil ValidateGenesisCmd analog (ref cmd/root.go:133): structural
    checks mirroring what init_chain assumes, so a bad hand-edited genesis
    fails HERE with a message instead of inside the node."""
    from celestia_app_tpu_torch.chain.crypto import PublicKey

    genesis = _load_genesis(args.home)
    errors: list[str] = []
    seen: set[str] = set()
    for i, a in enumerate(genesis.get("accounts", [])):
        addr = str(a.get("address", "")).lower()
        try:
            if len(bytes.fromhex(addr)) != 20:
                errors.append(f"accounts[{i}]: address not 20 bytes")
        except ValueError:
            errors.append(f"accounts[{i}]: address not hex")
        if addr in seen:
            errors.append(f"accounts[{i}]: duplicate address {addr}")
        seen.add(addr)
        try:
            if int(a.get("balance", -1)) < 0:
                errors.append(f"accounts[{i}]: negative balance")
        except (ValueError, TypeError):
            errors.append(f"accounts[{i}]: balance not an integer")
    vals = genesis.get("validators", [])
    if not vals:
        errors.append("no validators")
    for i, v in enumerate(vals):
        try:
            if int(v.get("power", 0)) <= 0:
                errors.append(f"validators[{i}]: non-positive power")
        except (ValueError, TypeError):
            errors.append(f"validators[{i}]: power not an integer")
        try:
            op = bytes.fromhex(str(v.get("operator", "")))
            if len(op) != 20:
                errors.append(f"validators[{i}]: operator not 20 bytes")
        except ValueError:
            errors.append(f"validators[{i}]: operator not hex")
            op = None
        pubhex = v.get("pubkey")
        if pubhex and op is not None:
            try:
                if PublicKey(bytes.fromhex(pubhex)).address() != op:
                    errors.append(
                        f"validators[{i}]: pubkey does not match operator"
                    )
            except Exception:
                errors.append(f"validators[{i}]: malformed pubkey")
    for khex, vhex in genesis.get("raw_modules", {}).items():
        try:
            bytes.fromhex(khex), bytes.fromhex(vhex)
        except ValueError:
            errors.append(f"raw_modules[{khex[:16]}...]: not hex")
            break
    for e in errors:
        print(f"invalid genesis: {e}", file=sys.stderr)
    if not errors:
        print("genesis.json is valid")
    return 1 if errors else 0


# Known-network genesis pins (ref cmd/download_genesis.go:19-24 — the
# command's real value is the hash check, which works offline too).
_GENESIS_SHA256 = {
    "celestia": "9727aac9bbfb021ce7fc695a92f901986421283a891b89e0af97bc9fad187793",
    "mocha-4": "0846b99099271b240b638a94e17a6301423b5e4047f6558df543d6e91db7e575",
    "arabica-10": "fad0a187669f7a2c11bb07f9dc27140d66d2448b7193e186312713856f28e3e1",
    "arabica-11": "77605cee57ce545b1be22402110d4baacac837bdc7fc3f5c74020abf9a08810f",
}


def cmd_download_genesis(args) -> int:
    """cmd/download_genesis.go analog: fetch (or locally verify) a known
    network's genesis and check it against the pinned SHA-256."""
    import hashlib

    from celestia_app_tpu_torch.net import transport

    chain_id = args.chain_id
    if chain_id not in _GENESIS_SHA256:
        print(f"unknown chain-id: {chain_id}. Must be one of: "
              + ", ".join(sorted(_GENESIS_SHA256)), file=sys.stderr)
        return 1
    out = os.path.join(args.home, "genesis.json")
    downloaded = False
    if not os.path.exists(out):
        url = ("https://raw.githubusercontent.com/celestiaorg/networks/"
               f"master/{chain_id}/genesis.json")
        try:
            os.makedirs(args.home, exist_ok=True)
            # raw bytes, not JSON: the pinned sha256 is over the exact
            # served bytes
            data = transport.DEFAULT.request(url, "", raw=True, timeout=10)
            with open(out, "wb") as f:
                f.write(data)
            downloaded = True
        except OSError as e:
            print(f"download failed ({e}); if you already have the file, "
                  f"place it at {out} and re-run to verify its hash",
                  file=sys.stderr)
            return 1
    with open(out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    want = _GENESIS_SHA256[chain_id]
    if digest != want:
        if downloaded:
            # never leave a just-fetched bad file wedging future runs
            os.remove(out)
            print(f"sha256 MISMATCH for {chain_id}: got {digest}, want "
                  f"{want}; removed the downloaded file — re-run to retry",
                  file=sys.stderr)
        else:
            print(f"sha256 MISMATCH for {chain_id}: got {digest}, want "
                  f"{want}; delete {out} to re-download", file=sys.stderr)
        return 1
    print(f"{out}: sha256 verified for {chain_id}")
    return 0


def _write_config(home: str, chain_id: str, device: str = "cuda") -> None:
    """THE node-local config writer (SURVEY §5.6 layer 4 — the reference's
    app.toml/config.toml knobs), shared by `init` and validator/devnet
    home setup so the key set can never drift between them. The reference's
    ``engine`` key is ``device`` here."""
    from celestia_app_tpu_torch import appconsts

    with open(os.path.join(home, "config.json"), "w") as f:
        json.dump(
            {
                "chain_id": chain_id,
                "app_version": 1,
                "device": device,
                "da_scheme": "rs2d-nmt",
                # mesh plane (docs/FORMATS.md §18.1): max_square_size
                # raises the CONSENSUS square cap to admit k=256/512
                # (null = reference 128; every validator must match);
                # produce_batch > 1 batch-extends that many planned
                # blocks per device dispatch on the produce path
                "max_square_size": None,
                "produce_batch": 1,
                # serving plane (das/packs.py): newest-N proof packs
                # kept under <home>/packs (0 = keep all, null = off)
                "pack_keep": 4,
                "min_gas_price": appconsts.DEFAULT_MIN_GAS_PRICE,
                "invariant_check_period": 0,
                "v2_upgrade_height": None,
                "upgrade_height_delay": None,
                "mempool_ttl_blocks": appconsts.MEMPOOL_TX_TTL_BLOCKS,
                "mempool_ttl_seconds": appconsts.MEMPOOL_TX_TTL_SECONDS,
                "mempool_max_txs": appconsts.MEMPOOL_MAX_TXS,
                "mempool_max_pool_bytes": appconsts.MEMPOOL_MAX_POOL_BYTES,
            },
            f, indent=2,
        )


def cmd_config(args) -> int:
    """config.Cmd analog (ref cmd/root.go:135): read or set node-local
    config keys in <home>/config.json. `get` with no key prints the whole
    effective config; `set` parses the value as JSON when possible (so
    numbers/null/bools round-trip) and refuses unknown keys — the writer
    above owns the key set."""
    path = os.path.join(args.home, "config.json")
    try:
        with open(path) as f:
            cfg = json.load(f)
    except FileNotFoundError:
        print(f"no config.json in {args.home} — run `init` first",
              file=sys.stderr)
        return 1
    if args.action == "get":
        if args.key is None:
            print(json.dumps(cfg, indent=2))
            return 0
        if args.key not in cfg:
            print(f"unknown config key {args.key!r}; known: "
                  + ", ".join(sorted(cfg)), file=sys.stderr)
            return 1
        print(json.dumps(cfg[args.key]))
        return 0
    if args.key is None or args.value is None:
        print("config set needs KEY and VALUE", file=sys.stderr)
        return 1
    if args.key not in cfg:
        print(f"unknown config key {args.key!r}; known: "
              + ", ".join(sorted(cfg)), file=sys.stderr)
        return 1
    try:
        value = json.loads(args.value)
    except json.JSONDecodeError:
        value = args.value  # bare string
    cfg[args.key] = value
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    print(f"{args.key} = {json.dumps(value)}")
    return 0


def cmd_start(args) -> int:
    from celestia_app_tpu_torch.chain.node import Node
    from celestia_app_tpu_torch.service.server import NodeService

    app, cfg = _make_app(args.home, args.device)
    from celestia_app_tpu_torch import appconsts

    if args.trace:
        trace_path = os.path.join(args.home, "data", "store_trace.jsonl")
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        app.enable_store_trace(trace_path)
        print(f"store trace -> {trace_path}", file=sys.stderr)
    node = Node(app, **_mempool_kwargs(cfg))
    svc = NodeService(node, port=args.listen)
    svc.serve_background()
    print(
        f"node started: chain {app.chain_id} at height {app.height}, "
        f"http on 127.0.0.1:{svc.port}, device {app.device}"
        f", block time {args.block_time}s",
        file=sys.stderr,
    )
    snap_interval = cfg.get(
        "snapshot_interval_blocks", appconsts.SNAPSHOT_INTERVAL_BLOCKS
    )
    snap_keep = cfg.get("snapshot_keep_recent", appconsts.SNAPSHOT_KEEP_RECENT)
    snap_root = os.path.join(args.home, "snapshots")
    # mesh plane: produce_batch > 1 plans that many blocks from the
    # mempool and batch-extends them in ONE device dispatch before the
    # per-block rounds run (chain/producer.py; FORMATS §18.1). The
    # planning+extend runs OUTSIDE the service lock — only the per-block
    # consensus round holds it, exactly as with batching off.
    produce_batch = max(1, int(cfg.get("produce_batch", 1)))
    produced = 0
    try:
        while args.blocks is None or produced < args.blocks:
            time.sleep(args.block_time)
            # one plan+warm per BATCH WINDOW (planning B squares per
            # produced block would multiply the greedy layout work by
            # B); a mid-window mempool change just means a per-block
            # extend for the affected heights
            if produce_batch > 1 and produced % produce_batch == 0:
                from celestia_app_tpu_torch.chain import producer

                try:
                    plans = producer.plan_block_squares(
                        app, node._reap(), produce_batch)
                    producer.warm_block_batch(app, plans)
                except Exception as e:
                    print(f"produce prewarm failed: {e}", file=sys.stderr)
            with svc.lock:
                blk, results = node.produce_block()
            produced += 1
            print(
                f"height {blk.header.height}: {len(blk.txs)} txs, "
                f"square {blk.header.square_size}, "
                f"data root {blk.header.data_hash.hex()[:16]}",
                file=sys.stderr,
            )
            if snap_interval and blk.header.height % snap_interval == 0:
                # interval state-sync snapshots with keep-recent pruning
                # (default_overrides.go:294-297: interval 1500, keep 2).
                # Only the state CAPTURE holds the service lock; chunk
                # encoding and disk writes run outside it. Snapshots are
                # auxiliary: any failure is logged, never fatal to block
                # production.
                from celestia_app_tpu_torch.chain import consensus as _cons

                try:
                    with svc.lock:
                        cap = _cons.capture_app_snapshot(app)
                    m, chunks = _cons.encode_app_snapshot(cap)
                    _write_snapshot_files(
                        m, chunks,
                        os.path.join(snap_root, str(blk.header.height)),
                    )
                    _prune_snapshots(snap_root, snap_keep)
                    print(
                        f"snapshot at height {m['height']} "
                        f"({m['n_chunks']} chunks)",
                        file=sys.stderr,
                    )
                except Exception as e:
                    print(f"snapshot at height {blk.header.height} "
                          f"failed: {e}", file=sys.stderr)
    except KeyboardInterrupt:
        pass
    finally:
        svc.shutdown()
    return 0


def cmd_status(args) -> int:
    from celestia_app_tpu_torch.chain.query import QueryRouter

    app, _ = _make_app(args.home, args.device)
    print(json.dumps(QueryRouter(app).query("status", {}), indent=2))
    return 0


def cmd_query(args) -> int:
    from celestia_app_tpu_torch.chain.query import QueryRouter

    app, _ = _make_app(args.home, args.device)
    data = json.loads(args.data) if args.data else {}
    print(json.dumps(QueryRouter(app).query(args.path, data), indent=2))
    return 0


def cmd_tx(args) -> int:
    """tx send / tx pay-for-blob against the local home: sign (protobuf
    wire), run through the node (CheckTx + one block), print the result —
    the x/blob CLI `tx blob pay-for-blob` analog (client/cli/payforblob.go)."""
    from celestia_app_tpu_torch.chain.crypto import PrivateKey
    from celestia_app_tpu_torch.chain.node import Node
    from celestia_app_tpu_torch.chain.state import Context, InfiniteGasMeter
    from celestia_app_tpu_torch.client.tx_client import Signer, TxClient
    from celestia_app_tpu_torch.da.blob import Blob
    from celestia_app_tpu_torch.da.namespace import Namespace

    if args.action == "send" and (args.to is None or args.amount is None):
        print("tx send requires --to and --amount", file=sys.stderr)
        return 2
    if args.action == "create-validator" and args.amount is None:
        print("tx create-validator requires --amount (self-stake, utia)",
              file=sys.stderr)
        return 2
    if args.action == "pay-for-blob" and args.input_file is None and (
        args.namespace is None or args.data is None
    ):
        print("tx pay-for-blob requires --namespace and --data "
              "(or --input-file blobs.json)", file=sys.stderr)
        return 2

    app, _cfg = _make_app(args.home, args.device)
    node = Node(app)
    priv = PrivateKey.from_seed(args.from_seed.encode())
    addr = priv.public_key().address()
    ctx = Context(app.store, InfiniteGasMeter(), app.height, 0,
                  app.chain_id, app.app_version)
    acc = app.auth.account(ctx, addr)
    signer = Signer(app.chain_id)
    signer.add_account(priv, acc["number"] if acc else 0,
                       acc["sequence"] if acc else 0)
    client = TxClient(node, signer)
    if args.action == "send":
        height, res = client.submit_send(
            addr, bytes.fromhex(args.to), int(args.amount)
        )
    elif args.action == "create-validator":
        # stake in with the signer's own consensus pubkey registered
        # on-chain, so a running autonomous network adopts this address
        # into rotation (chain/reactor.py valset-update flow)
        height, res = client.submit_create_validator(
            addr, int(args.amount), priv.public_key().compressed
        )
    else:  # pay-for-blob
        if args.input_file is not None:
            if args.namespace is not None or args.data is not None:
                print("--input-file conflicts with --namespace/--data; "
                      "pass one or the other", file=sys.stderr)
                return 2
            # multi-blob file input, the reference's --input-file JSON
            # schema (x/blob/client/cli/payforblob.go:60-76):
            # {"Blobs": [{"namespaceID": "0x..10 bytes..", "blob": "0x.."}]}
            # The file is user input: every malformed shape gets a usage
            # error naming the entry, never a traceback.
            try:
                with open(args.input_file) as f:
                    doc = json.load(f)
                entries = (doc.get("Blobs") or doc.get("blobs")
                           if isinstance(doc, dict) else None)
                if not entries:
                    print(f"{args.input_file}: no Blobs array",
                          file=sys.stderr)
                    return 2
                blobs = []
                for i, e in enumerate(entries):
                    if not isinstance(e, dict) or "namespaceID" not in e \
                            or "blob" not in e:
                        print(f"{args.input_file}: Blobs[{i}] needs "
                              "namespaceID and blob", file=sys.stderr)
                        return 2
                    ns_hex = str(e["namespaceID"]).removeprefix("0x")
                    blob_hex = str(e["blob"]).removeprefix("0x")
                    blobs.append(
                        Blob(Namespace.v0(bytes.fromhex(ns_hex)),
                             bytes.fromhex(blob_hex))
                    )
            except (OSError, json.JSONDecodeError, ValueError) as e:
                print(f"{args.input_file}: {e}", file=sys.stderr)
                return 2
        else:
            ns = Namespace.v0(bytes.fromhex(args.namespace))
            if args.data.startswith("@"):
                with open(args.data[1:], "rb") as f:
                    payload = f.read()
            else:
                payload = bytes.fromhex(args.data)
            blobs = [Blob(ns, payload)]
        height, res = client.submit_pay_for_blob(addr, blobs)
    # commits already hit disk inside produce_block (durable save_commit)
    print(json.dumps({
        "height": height,
        "code": res.code,
        "log": res.log,
        "gas_wanted": res.gas_wanted,
        "gas_used": res.gas_used,
    }, indent=2))
    return 0 if res.code == 0 else 1


def _ensure_home_config(home: str, chain_id: str, device: str) -> None:
    """Make a validator home a first-class CLI --home: with config.json in
    place (and data under <home>/data), `snapshot create`, `query`,
    `export`, `blockscan` etc. all work against a stopped validator. The
    home records the device its validator was started on (the reference
    records engine=host: it has a host engine, the port has none)."""
    if not os.path.exists(os.path.join(home, "config.json")):
        _write_config(home, chain_id, device=device)


def _check_legacy_validator_home(home: str) -> str | None:
    """Pre-round-4 layout detection: validator state at the HOME ROOT
    instead of <home>/data. Returns an error message, or None when clean.
    Silently adopting such a home would reset the validator to genesis AND
    re-sign heights it already signed."""
    data_dir = os.path.join(home, "data")
    legacy = [
        p for p in ("state", "wal", "LATEST")
        if os.path.exists(os.path.join(home, p))
    ]
    if legacy and not os.path.isdir(data_dir):
        return (
            f"{home} holds pre-round-4 validator state "
            f"({', '.join(legacy)}) at the home root; move it under "
            f"{data_dir}/ before starting, or this validator would "
            "silently reset to genesis and double-sign."
        )
    return None


def cmd_da_serve(args) -> int:
    """Standalone DA-core service (SURVEY §7.1.7 sidecar shape): serves
    /da/extend_commit and /da/prove_shares with NO chain attached — a
    foreign node (see shim/go/tpuda) points its da.ExtendShares
    replacement here and keeps everything else. It runs on the device
    (the reference's --engine host|device; its --grpc is not ported)."""
    from celestia_app_tpu_torch.service.da_service import DACore, DAService

    core = DACore(device=_torch_device(args.device))
    svc = DAService(core, port=args.listen)
    print(f"da-serve: http on :{svc.port} (device={core.device})",
          flush=True)
    try:
        svc.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_das_serve(args) -> int:
    """DAS sample-proof server over a full node's home (das/server.py):
    answers light-node samplers (`das-follow`) with cells + NMT proofs
    from the committed block store — the serving half of the DAS plane,
    deployable next to (or instead of) the full node process."""
    from celestia_app_tpu_torch.das.server import SampleCore, SampleService

    app, _cfg = _make_app(args.home, args.device)
    core = SampleCore(app, cache_heights=args.cache_heights)
    if getattr(args, "no_packs", False):
        core.pack_store = None
    svc = SampleService(core, port=args.listen)
    packs_on = core.pack_store is not None
    print(f"das-serve: http on :{svc.port} (height {app.height}, "
          f"device={app.device}, "
          f"packs={'on' if packs_on else 'off'})", flush=True)
    try:
        svc.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_blob_serve(args) -> int:
    """Read-plane sidecar over a full node's home (das/blob_server.py):
    answers rollup readers — GET /blob/get, batched POST
    /blob/namespaces, static blob-pack chunks — plus the /das/* routes a
    verifying follower needs for headers. Deployable next to (or instead
    of) the full node process; any number can front one home."""
    from celestia_app_tpu_torch.das.blob_server import BlobCore, BlobService
    from celestia_app_tpu_torch.das.server import SampleCore

    app, _cfg = _make_app(args.home, args.device)
    core = SampleCore(app, cache_heights=args.cache_heights)
    blob_core = BlobCore(core)
    if getattr(args, "no_packs", False):
        blob_core.pack_store = None
    svc = BlobService(blob_core, port=args.listen)
    packs_on = blob_core.pack_store is not None
    print(f"blob-serve: http on :{svc.port} (height {app.height}, "
          f"device={app.device}, "
          f"packs={'on' if packs_on else 'off'})", flush=True)
    try:
        svc.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_das_follow(args) -> int:
    """DASer daemon (das/daser.py): follow a chain as a light node —
    verify headers by commit certificate (chain/light.py), sample every
    height, checkpoint progress under --home, and halt on a verified
    bad-encoding fraud proof. Exit codes: 0 clean stop, 1 halted, 2 bad
    invocation."""
    import numpy as np

    from celestia_app_tpu_torch.chain.light import LightClient, TrustedState
    from celestia_app_tpu_torch.das.checkpoint import CheckpointStore
    from celestia_app_tpu_torch.das.daser import DASer, DASerConfig

    if not args.peer:
        print("error: das-follow needs at least one --peer", file=sys.stderr)
        return 2
    genesis_path = os.path.join(args.home, "genesis.json")
    if not os.path.exists(genesis_path):
        print(f"error: no genesis.json under {args.home} (trust root)",
              file=sys.stderr)
        return 2
    with open(genesis_path) as f:
        genesis = json.load(f)
    validators, powers = {}, {}
    for v in genesis.get("validators", []):
        if "pubkey" not in v:
            print("error: genesis validators need pubkeys for light "
                  "verification", file=sys.stderr)
            return 2
        op = bytes.fromhex(v["operator"])
        validators[op] = bytes.fromhex(v["pubkey"])
        powers[op] = int(v["power"])
    light = LightClient(args.chain_id, TrustedState(
        height=0, header_hash=b"", validators=validators, powers=powers,
    ))
    store = CheckpointStore(os.path.join(args.home, "das",
                                         "checkpoint.json"))
    cfg = DASerConfig(
        samples_per_header=args.samples,
        workers=args.workers,
        poll_interval=args.interval,
        prefer_packs=not getattr(args, "no_packs", False),
    )
    daser = DASer(list(args.peer), light, store, cfg=cfg,
                  rng=np.random.default_rng(args.seed), name="das-follow",
                  device=_torch_device(args.device))
    if daser.halted:
        print(json.dumps({"halted": daser.cp.halted}), flush=True)
        return 1
    try:
        while not daser.halted:
            out = daser.sync()
            print(json.dumps(out), flush=True)
            if out.get("halted"):
                break  # a halt during header following returns a
                # halted-only dict; fall through to the exit-1 line
            if args.once and out.get("sample_from", 0) > out.get("head", -1) >= 1:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    print(json.dumps({"halted": daser.cp.halted}), flush=True)
    return 1


def cmd_blob_follow(args) -> int:
    """Rollup follower daemon (client/follower.py): track ONE namespace
    across heights as a verifying light client — headers by commit
    certificate (chain/light.py), every inclusion/absence proof checked
    against the certified data root, progress checkpointed under
    --home/blob/. Exit codes: 0 clean stop, 1 verification refusal,
    2 bad invocation."""
    from celestia_app_tpu_torch.chain.light import LightClient, TrustedState
    from celestia_app_tpu_torch.client.follower import (
        BlobFollower,
        FollowerConfig,
        FollowerError,
    )
    from celestia_app_tpu_torch.das.checkpoint import CheckpointStore

    if not args.peer:
        print("error: blob-follow needs at least one --peer",
              file=sys.stderr)
        return 2
    try:
        namespace = bytes.fromhex(args.namespace)
    except ValueError:
        namespace = b""
    if len(namespace) != 29:
        print("error: --namespace must be 29 bytes of hex",
              file=sys.stderr)
        return 2
    genesis_path = os.path.join(args.home, "genesis.json")
    if not os.path.exists(genesis_path):
        print(f"error: no genesis.json under {args.home} (trust root)",
              file=sys.stderr)
        return 2
    with open(genesis_path) as f:
        genesis = json.load(f)
    validators, powers = {}, {}
    for v in genesis.get("validators", []):
        if "pubkey" not in v:
            print("error: genesis validators need pubkeys for light "
                  "verification", file=sys.stderr)
            return 2
        op = bytes.fromhex(v["operator"])
        validators[op] = bytes.fromhex(v["pubkey"])
        powers[op] = int(v["power"])
    light = LightClient(args.chain_id, TrustedState(
        height=0, header_hash=b"", validators=validators, powers=powers,
    ))
    store = CheckpointStore(os.path.join(args.home, "blob",
                                         "checkpoint.json"))
    follower = BlobFollower(
        list(args.peer), namespace, light, store,
        cfg=FollowerConfig(prefer_packs=not getattr(args, "no_packs",
                                                    False)),
        name="blob-follow",
    )
    try:
        while True:
            try:
                out = follower.sync()
            except FollowerError as e:
                print(json.dumps({"refused": str(e)}), flush=True)
                return 1
            for h, blobs in sorted(follower.pop_blobs().items()):
                print(json.dumps({"height": h, "blobs": [
                    b.hex() for b in blobs]}), flush=True)
            print(json.dumps(out), flush=True)
            if args.once and out["next_height"] > out["head"] >= 1:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_verify(args) -> int:
    """Blobstream verification CLI (x/blobstream/client verify analog,
    ref client/verify.go:27-38): prove that shares at a height are
    covered by an on-chain data-commitment attestation — share proof to
    the block's data root, then the data-root tuple proof to the
    attestation's commitment root, the exact value an EVM Blobstream
    contract stores per nonce. The reference queries a live Ethereum
    contract; with no external chain here, the root is recomputed from
    the home's own attested height range, which is the same statement an
    orchestrator would have relayed."""
    from celestia_app_tpu_torch.chain import blobstream as bs
    from celestia_app_tpu_torch.chain.query import QueryRouter
    from celestia_app_tpu_torch.chain.state import Context, InfiniteGasMeter

    app, _cfg = _make_app(args.home, args.device)
    if app.height < args.height:
        print(f"home is at height {app.height}; {args.height} not committed",
              file=sys.stderr)
        return 1
    ctx = Context(app.store, InfiniteGasMeter(), app.height, 0,
                  app.chain_id, app.app_version)

    # find the data-commitment attestation whose range covers the height
    latest = app.blobstream.latest_attestation_nonce(ctx)
    if latest is None:
        print("no blobstream attestations in state (v1 only; the module "
              "is disabled from app version 2)", file=sys.stderr)
        return 1
    dc = None
    for nonce in range(latest, 0, -1):
        att = app.blobstream.attestation_by_nonce(ctx, nonce)
        if (isinstance(att, bs.DataCommitment)
                and att.begin_block <= args.height < att.end_block):
            dc = att
            break
    if dc is None:
        print(f"height {args.height} is not covered by any data "
              "commitment yet (window boundary not reached)",
              file=sys.stderr)
        return 1

    # share proof -> data root (the same prover the query routes use)
    qr = QueryRouter(app)
    prover, data_root = qr.prover_for(args.height)
    ns = bytes.fromhex(args.namespace) if args.namespace else \
        prover.eds.squares[0, 0, :29].tobytes()
    proof = prover.prove_shares(args.start, args.end, ns)
    if not proof.verify(data_root):
        print("FAILED: share proof does not verify against the data root",
              file=sys.stderr)
        return 1

    # data root -> attestation tuple root (what the EVM contract stores)
    data_roots = {}
    for h in range(dc.begin_block, dc.end_block):
        if h < 1 or h > app.height:
            continue
        data_roots[h] = app.db.load_block(h).header.data_hash
    tuple_root = bs.data_commitment_root(dc, data_roots)
    tproof = bs.data_root_tuple_proof(dc, data_roots, args.height)
    if not bs.verify_data_root_inclusion(
        args.height, data_root, tuple_root, tproof
    ):
        print("FAILED: data root not included in the attestation's "
              "tuple root", file=sys.stderr)
        return 1
    print(json.dumps({
        "verified": True,
        "height": args.height,
        "shares": [args.start, args.end],
        "namespace": ns.hex(),
        "data_root": data_root.hex(),
        "attestation_nonce": dc.nonce,
        "attestation_range": [dc.begin_block, dc.end_block],
        "data_commitment_root": tuple_root.hex(),
    }, indent=2))
    return 0


def cmd_multihost_worker(args) -> int:
    """One host of the multi-host mesh (spawned by multihost-dryrun)."""
    from celestia_app_tpu_torch.parallel import multihost

    out = multihost.worker_main(
        args.process_id, args.num_processes, args.coordinator,
        args.k, args.batch, args.devices_per_host, _torch_device(args.device),
    )
    print(json.dumps(out))
    return 0


def cmd_multihost_dryrun(args) -> int:
    """N OS processes x M seq shards = one global mesh running the
    sharded block pipeline, every host feeding only its own rows; every
    host's data roots must match the single-host oracle."""
    from celestia_app_tpu_torch.parallel import multihost

    if args.processes < 1 or args.devices_per_host < 1:
        print("--processes and --devices-per-host must be >= 1",
              file=sys.stderr)
        return 2
    out = multihost.spawn_dryrun(
        k=args.k, batch=args.batch, num_processes=args.processes,
        devices_per_host=args.devices_per_host, device=_torch_device(args.device),
    )
    print(json.dumps(out))
    return 0 if out["all_hosts_match_oracle"] else 1


def cmd_e2e_bench(args) -> int:
    """Throughput benchmark on the autonomous process devnet — see
    tools/e2e_bench.py (the test/e2e/benchmark/throughput.go analog)."""
    from celestia_app_tpu_torch.tools import e2e_bench

    return e2e_bench.run(args, _spawn_validator_processes,
                         _terminate_processes)


def cmd_validator_serve(args) -> int:
    """One validator as its own OS process (the reference's one-binary-per-
    validator deployment): loads key + genesis from --home, resumes durable
    state, replays any WAL entries ahead of the committed height, then
    serves the HTTP consensus surface until killed. Writes endpoint.json
    (host/port) into --home so the spawner can discover the bound port.
    SIGTERM stops it as Ctrl-C does; on the way out it writes its exit line
    (`EXIT_LINE_PREFIX`) to stderr."""
    from celestia_app_tpu_torch.chain import consensus
    from celestia_app_tpu_torch.chain.crypto import PrivateKey
    from celestia_app_tpu_torch.service.validator_server import ValidatorService

    with open(os.path.join(args.home, "genesis.json")) as f:
        genesis = json.load(f)
    with open(os.path.join(args.home, "key.json")) as f:
        key_doc = json.load(f)
    _ensure_home_config(args.home, args.chain_id, args.device)
    priv = PrivateKey.from_seed(bytes.fromhex(key_doc["seed_hex"]))
    # layout: validator state lives under <home>/data (so the home doubles
    # as a CLI --home); a pre-round-4 home is refused loudly
    err = _check_legacy_validator_home(args.home)
    if err is not None:
        print(f"ERROR: {err}", file=sys.stderr)
        return 1
    with open(os.path.join(args.home, "config.json")) as f:
        home_cfg = json.load(f)
    vnode = consensus.ValidatorNode(
        key_doc.get("name", "val"), priv, genesis, args.chain_id,
        data_dir=os.path.join(args.home, "data"),
        # the coordinated v1->v2 flip height (reference
        # --v2-upgrade-height) and the x/signal scheduling delay: both
        # consensus-critical, so both ride the home config every
        # validator is provisioned with
        v2_upgrade_height=home_cfg.get("v2_upgrade_height"),
        upgrade_height_delay=home_cfg.get("upgrade_height_delay"),
        # the DA commitment scheme (codec plane) is consensus-critical
        # like the upgrade knobs above: every validator of a chain must
        # be provisioned with the same one (absent ⇒ rs2d-nmt)
        da_scheme=home_cfg.get("da_scheme", "rs2d-nmt"),
        # serving plane: precompute static proof packs at warm time
        # (<home>/packs, newest-N kept; null = off)
        pack_keep=home_cfg.get("pack_keep", 4),
        # mesh plane: the consensus-critical k=256/512 square-cap
        # override — provisioned identically across the chain or absent
        max_square_size=home_cfg.get("max_square_size"),
        # the block plane runs on the card unless the process was asked
        # for the CPU (the reference defaults validators to its host engine)
        device=_torch_device(args.device),
        mesh=_mesh_of(args.device),
    )
    # fault plane (chaos provisioning): <home>/faults.json arms named
    # fault points for THIS process at startup — the config-file twin of
    # the runtime /faults/* admin endpoint
    faults_path = os.path.join(args.home, "faults.json")
    if os.path.exists(faults_path):
        from celestia_app_tpu_torch import faults as faults_mod

        with open(faults_path) as f:
            armed = faults_mod.arm_from_spec(json.load(f))
        print(f"armed {len(armed)} fault(s) from faults.json",
              file=sys.stderr, flush=True)
    try:
        vnode.app.load()  # resume at the durable committed height
    except ValueError:
        pass  # fresh home: stay at the genesis state init_chain built
    replayed = vnode.replay_wal()
    svc = ValidatorService(vnode, port=args.port)
    endpoint = {"host": "127.0.0.1", "port": svc.port}
    http_service = None
    if args.http is not None:
        # the node query surface (status/block/abci_query incl. proof
        # routes, /trace, /metrics) from the same process
        from celestia_app_tpu_torch.service.server import NodeService

        http_service = NodeService(vnode, port=args.http)
        http_service.lock = svc.lock  # one writer lock for the process
        http_service.das_core.app_lock = svc.lock
        http_service.serve_background()
        endpoint["http_port"] = http_service.port
    # atomic publish: the spawner polls for this file and must never read
    # a half-written JSON body
    ep_tmp = os.path.join(args.home, "endpoint.json.tmp")
    with open(ep_tmp, "w") as f:
        json.dump(endpoint, f)
    os.replace(ep_tmp, os.path.join(args.home, "endpoint.json"))
    print(
        f"{vnode.name}: serving on 127.0.0.1:{svc.port} at height "
        f"{vnode.app.height} (wal replayed {replayed})",
        file=sys.stderr, flush=True,
    )
    if getattr(args, "autonomous", False):
        # peer discovery: the spawner learns every endpoint, then drops
        # peers.json into each home — the address-book handoff (the
        # reference's persistent_peers config.toml entry)
        import threading
        import time as time_mod

        def arm_reactor() -> None:
            peers_path = os.path.join(args.home, "peers.json")
            for _ in range(1200):
                if os.path.exists(peers_path):
                    break
                time_mod.sleep(0.25)
            else:
                print("no peers.json appeared; reactor not started",
                      file=sys.stderr, flush=True)
                return
            with open(peers_path) as f:
                peers = json.load(f)
            from celestia_app_tpu_torch.chain.reactor import ReactorConfig

            cfg_doc = {}
            cfg_path = os.path.join(args.home, "reactor.json")
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    cfg_doc = json.load(f)
            # sync plane: the home config's snapshot knobs (the same keys
            # cmd_start reads) feed the reactor's interval-snapshot hook;
            # an explicit reactor.json entry wins
            if "snapshot_interval" not in cfg_doc and \
                    "snapshot_interval_blocks" in home_cfg:
                cfg_doc["snapshot_interval"] = \
                    home_cfg["snapshot_interval_blocks"]
            if "snapshot_keep" not in cfg_doc and \
                    "snapshot_keep_recent" in home_cfg:
                cfg_doc["snapshot_keep"] = home_cfg["snapshot_keep_recent"]
            # mesh plane: the produce→commit batching knob rides the
            # same home-config feed (an explicit reactor.json wins)
            if "produce_batch" not in cfg_doc and \
                    "produce_batch" in home_cfg:
                cfg_doc["produce_batch"] = home_cfg["produce_batch"]
            cfg = ReactorConfig(**cfg_doc)
            svc.attach_reactor([u for u in peers if u !=
                                f"http://127.0.0.1:{svc.port}"], cfg)
            print(f"{vnode.name}: autonomous reactor up "
                  f"({len(peers) - 1} peers)", file=sys.stderr, flush=True)

        threading.Thread(target=arm_reactor, daemon=True).start()
    import signal
    import threading

    def stop(_signum, _frame):
        raise KeyboardInterrupt  # the spawner's SIGTERM: the Ctrl-C exit

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, stop)
    try:
        svc.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # the line first: a spawner kills a child that is slow to stop. One
        # write, newline included: print writes the newline apart, and another
        # thread's output could land between the two on the same line
        sys.stderr.write(EXIT_LINE_PREFIX + json.dumps(_exit_doc(vnode)) + "\n")
        sys.stderr.flush()
        if svc.reactor is not None:
            svc.reactor.stop()
        if http_service is not None:
            http_service.shutdown()
        _quiesce(vnode.app)
    return 0


def _quiesce(app) -> None:
    """Let the App's prover warmer finish before the process goes on to
    exit: torch work still running on a thread while the interpreter
    shuts down aborts the process."""
    warmer = getattr(app, "da_warmer", None)
    if warmer is not None:
        warmer.wait_idle(120)


def _exit_doc(vnode) -> dict:
    """What a validator process did on its device: the device, the K1 and
    K2 launches it counted, its height, and its peak device memory (a card
    only)."""
    import torch

    from celestia_app_tpu_torch.ops import rs_kernel, sha256_kernel

    dev = vnode.app.device
    return {
        "name": vnode.name,
        "device": str(dev),
        "height": vnode.app.height,
        "k1_launches": sha256_kernel.compress_words.launches,
        "k2_launches": rs_kernel.extend_lines.launches,
        "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                     if dev.type == "cuda" else None),
    }


def _spawn_validator_processes(args, genesis, extra_flags=(),
                               reactor_cfg: dict | None = None):
    """Shared devnet scaffolding: one `validator-serve` OS process per
    validator home under args.home. Writes genesis/key (+ optional
    reactor.json), clears stale discovery files, spawns, then polls each
    home's endpoint.json. Returns (procs, homes, urls); on ANY setup
    failure the already-spawned processes are killed before the error
    propagates (the caller's finally never sees half a fleet).

    Every child runs `python -m celestia_app_tpu_torch` from the directory
    that holds this package, with the parent's ``--device``. On a card the
    CUDA kernels are built here first, once, so that the children only load
    them."""
    import subprocess
    import time as time_mod

    if _torch_device(args.device).split(":")[0] == "cuda":
        from celestia_app_tpu_torch import cuda_build

        cuda_build.build()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs, homes, urls = [], [], []
    try:
        for i in range(args.validators):
            home = os.path.abspath(os.path.join(args.home, f"val{i}"))
            os.makedirs(home, exist_ok=True)
            # fail fast here too: the spawned validator's own refusal
            # would otherwise surface only as a 50s "never came up"
            # timeout (its output goes to <home>/validator.log)
            err = _check_legacy_validator_home(home)
            if err is not None:
                raise RuntimeError(err)
            with open(os.path.join(home, "genesis.json"), "w") as f:
                json.dump(genesis, f)
            with open(os.path.join(home, "key.json"), "w") as f:
                json.dump({"seed_hex": f"devnet-{i}".encode().hex(),
                           "name": f"val{i}"}, f)
            if reactor_cfg is not None:
                with open(os.path.join(home, "reactor.json"), "w") as f:
                    json.dump(reactor_cfg, f)
            for stale in ("endpoint.json", "peers.json"):
                sp = os.path.join(home, stale)
                if os.path.exists(sp):
                    os.unlink(sp)
            # per-validator log file (the reference's --log-to-file): a
            # devnulled validator would hide reactor errors exactly when
            # a devnet misbehaves
            log_f = open(os.path.join(home, "validator.log"), "a")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "celestia_app_tpu_torch",
                 "validator-serve", "--home", home,
                 "--chain-id", args.chain_id, "--device", args.device,
                 *extra_flags],
                stdout=log_f, stderr=subprocess.STDOUT, cwd=root,
            ))
            log_f.close()  # the child holds its own fd now
            homes.append(home)

        for i, home in enumerate(homes):
            ep = os.path.join(home, "endpoint.json")
            # a child imports torch and opens its device first: slow
            for _ in range(200):
                if os.path.exists(ep):
                    break
                time_mod.sleep(0.25)
            else:
                raise RuntimeError(f"validator at {home} never came up")
            with open(ep) as f:
                doc = json.load(f)
            urls.append(f"http://{doc['host']}:{doc['port']}")
            extras = ", ".join(
                f"{k.removesuffix('_port')} :{v}"
                for k, v in doc.items() if k.endswith("_port")
            )
            print(f"val{i}: consensus {urls[-1]}"
                  + (f", {extras}" if extras else ""), file=sys.stderr)
        return procs, homes, urls
    except BaseException:
        _terminate_processes(procs)
        raise


def _terminate_processes(procs) -> None:
    for pr in procs:
        pr.terminate()
    for pr in procs:
        try:
            pr.wait(timeout=5)
        except Exception:
            pr.kill()


def _devnet_autonomous(args, privs, genesis) -> int:
    """devnet --processes --autonomous: one OS process per validator and NO
    coordinator — each process runs its own consensus reactor
    (chain/reactor.py), gossiping proposals/votes/txs peer-to-peer. This
    process only seeds the address book (peers.json), optionally submits
    load, and watches statuses for progress + divergence (the reference's
    devnet observer role)."""
    import base64
    import time as time_mod

    from celestia_app_tpu_torch.chain.tx import MsgSend
    from celestia_app_tpu_torch.client.tx_client import Signer
    from celestia_app_tpu_torch.net.transport import PeerClient, TransportConfig

    n = args.validators
    procs, homes, urls = _spawn_validator_processes(
        args, genesis,
        extra_flags=("--autonomous", "--http", "0"),
        # pace the reactors to the requested block time; generous propose
        # window (a first proposal may pay a cold jit compile) but quick
        # rotation past dead peers
        reactor_cfg={
            "timeout_propose": max(15.0, 10 * args.block_time),
            "timeout_prevote": max(8.0, 5 * args.block_time),
            "timeout_precommit": max(8.0, 5 * args.block_time),
            "timeout_delta": 2.0,
            "block_interval": args.block_time,
        },
    )
    try:
        # hand every validator the address book; reactors arm on sight
        for home in homes:
            tmp = os.path.join(home, "peers.json.tmp")
            with open(tmp, "w") as f:
                json.dump(urls, f)
            os.replace(tmp, os.path.join(home, "peers.json"))

        # the observer's transport: breaker state keeps the watch loop
        # from stalling 5 s per poll on a crashed validator
        net = PeerClient(TransportConfig(timeout=5.0, retries=1),
                         name="devnet-observer")

        def status(u: str) -> dict | None:
            try:
                return net.get(u, "/consensus/status")
            except OSError:
                return None

        def commit_at(u: str, h: int) -> dict | None:
            try:
                return net.get(u, f"/gossip/commit_at?height={h}") or None
            except OSError:
                return None

        signer = Signer(args.chain_id)
        for i, p in enumerate(privs):
            signer.add_account(p, number=i)
        a0 = privs[0].public_key().address()
        a1 = privs[1 % n].public_key().address()
        target = args.blocks or 5
        sent = 0
        deadline = time_mod.monotonic() + max(120.0, 30.0 * target)
        last_min = -1
        while time_mod.monotonic() < deadline:
            sts = [status(u) for u in urls]
            heights = [s["height"] for s in sts if s]
            if not heights:
                time_mod.sleep(0.5)
                continue
            lo = min(heights)
            if lo != last_min:
                print(f"heights: {heights}", file=sys.stderr)
                last_min = lo
            if args.load and sent < lo + 1:
                tx = signer.create_tx(a0, [MsgSend(a0, a1, 1 + sent)],
                                      fee=2000, gas_limit=100_000)
                try:
                    res = net.post(
                        urls[sent % n], "/broadcast_tx",
                        {"tx": base64.b64encode(tx.encode()).decode()},
                        timeout=10,
                    )
                    if res["code"] == 0:
                        signer.accounts[a0].sequence += 1
                        sent += 1
                except OSError:
                    pass
            if lo >= target:
                break
            time_mod.sleep(args.block_time / 4)
        else:
            print("ERROR: devnet did not reach the target height",
                  file=sys.stderr)
            return 1

        # divergence gate: every validator that holds the commit record
        # for the last common height must report the SAME block hash (the
        # header commits to the previous app hash, so block-hash equality
        # is state equality one height back)
        final_heights = [
            s["height"] for s in (status(u) for u in urls) if s
        ]
        if not final_heights:
            print("ERROR: no validator reachable for the final check",
                  file=sys.stderr)
            return 1
        lo = min(final_heights)
        block_hashes = set()
        holders = 0
        for u in urls:
            doc = commit_at(u, lo)
            if doc:
                holders += 1
                block_hashes.add(doc["cert"]["block_hash"])
        if holders >= 2 and len(block_hashes) != 1:
            print(f"DIVERGENCE at height {lo}: {sorted(block_hashes)}",
                  file=sys.stderr)
            return 1
        print(json.dumps({
            "validators": n,
            "processes": True,
            "autonomous": True,
            "blocks": lo,
            "txs_submitted": sent,
            "block_hash": next(iter(block_hashes)) if block_hashes else None,
        }))
        return 0
    finally:
        _terminate_processes(procs)


def _devnet_processes(args, privs, genesis) -> int:
    """devnet --processes: one OS process per validator, consensus over
    sockets (VERDICT r3 #4). Produces --blocks heights through the
    SocketNetwork orchestrator and checks every process lands on the same
    app hash."""
    import time as time_mod

    from celestia_app_tpu_torch.chain.remote_consensus import (
        RemoteValidator, SocketNetwork,
    )
    from celestia_app_tpu_torch.client.tx_client import Signer
    from celestia_app_tpu_torch.chain.tx import MsgSend

    n = args.validators
    procs, homes, urls = _spawn_validator_processes(
        args, genesis, extra_flags=("--http", "0"),
    )
    try:
        peers = [RemoteValidator(u) for u in urls]
        net = SocketNetwork(peers, genesis, args.chain_id)

        signer = Signer(args.chain_id)
        for i, p in enumerate(privs):
            signer.add_account(p, number=i)
        a0 = privs[0].public_key().address()
        a1 = privs[1 % n].public_key().address()
        t = time.time()
        produced = 0
        while args.blocks is None or produced < args.blocks:
            if args.load and n >= 2:
                tx = signer.create_tx(
                    a0, [MsgSend(a0, a1, 1 + produced)],
                    fee=2000, gas_limit=100_000,
                )
                if net.broadcast_tx(tx.encode()):
                    signer.accounts[a0].sequence += 1
            t += args.block_time
            height, app_hash = net.produce_height(t=t)
            if height is None:
                print("round failed; rotating proposer", file=sys.stderr)
                continue
            produced += 1
            statuses = [p.status() for p in net.peers]
            print(
                f"height {height}: processes at "
                f"{[s['height'] for s in statuses]}, app hash "
                f"{sorted({s['app_hash'][:12] for s in statuses})}",
                file=sys.stderr,
            )
            if args.blocks is None:
                time_mod.sleep(args.block_time)
        final = {p.status()["app_hash"] for p in net.peers}
        if len(final) != 1:
            print(f"DIVERGENCE: {sorted(final)}", file=sys.stderr)
            return 1
        print(json.dumps({
            "validators": n,
            "processes": True,
            "blocks": produced,
            "final_height": net.peers[0].status()["height"],
            "app_hash": next(iter(final)),
        }))
        return 0
    finally:
        _terminate_processes(procs)


def cmd_devnet(args) -> int:
    """N-validator in-process devnet (the reference's local_devnet
    docker-compose analog): real consensus (signed precommits, >2/3
    certificates, WAL, per-node durable state under --home/val<i>), one
    HTTP service per validator, txsim-style load if requested."""
    from celestia_app_tpu_torch.chain import consensus
    from celestia_app_tpu_torch.chain.crypto import PrivateKey
    from celestia_app_tpu_torch.chain.node import Node
    from celestia_app_tpu_torch.client.tx_client import Signer
    from celestia_app_tpu_torch.service.server import NodeService
    from celestia_app_tpu_torch.chain.tx import MsgSend

    n = args.validators
    privs = [PrivateKey.from_seed(f"devnet-{i}".encode()) for i in range(n)]
    genesis = {
        "time_unix": time.time(),
        "accounts": [
            {"address": p.public_key().address().hex(), "balance": 10**12}
            for p in privs
        ],
        "validators": [
            {
                "operator": p.public_key().address().hex(),
                "power": 10,
                "pubkey": p.public_key().compressed.hex(),
            }
            for p in privs
        ],
    }
    os.makedirs(args.home, exist_ok=True)
    if getattr(args, "autonomous", False):
        if not args.processes:
            print("ERROR: --autonomous requires --processes",
                  file=sys.stderr)
            return 1
        return _devnet_autonomous(args, privs, genesis)
    if args.processes:
        return _devnet_processes(args, privs, genesis)
    nodes = []
    for i in range(n):
        home = os.path.join(args.home, f"val{i}")
        os.makedirs(home, exist_ok=True)
        err = _check_legacy_validator_home(home)
        if err is not None:
            print(f"ERROR: {err}", file=sys.stderr)
            return 1
        with open(os.path.join(home, "genesis.json"), "w") as f:
            json.dump(genesis, f)
        _ensure_home_config(home, args.chain_id, args.device)
        nodes.append(consensus.ValidatorNode(
            f"val{i}", privs[i], genesis, args.chain_id,
            data_dir=os.path.join(home, "data"), device=_torch_device(args.device),
            mesh=_mesh_of(args.device),
        ))
    net = consensus.LocalNetwork(nodes)
    services = []
    for vn in net.nodes:
        svc = NodeService(Node(vn.app), port=0)
        svc.serve_background()
        services.append(svc)
        print(f"{vn.name}: http://127.0.0.1:{svc.port}", file=sys.stderr)

    signer = Signer(args.chain_id)
    for i, p in enumerate(privs):
        signer.add_account(p, number=i)
    t = time.time()
    produced = 0
    a0 = privs[0].public_key().address()
    a1 = privs[1 % n].public_key().address()
    try:
        while args.blocks is None or produced < args.blocks:
            if args.load and n >= 2:
                tx = signer.create_tx(
                    a0, [MsgSend(a0, a1, 1 + produced)],
                    fee=2000, gas_limit=100_000,
                )
                if net.broadcast_tx(tx.encode()):
                    signer.accounts[a0].sequence += 1
            t += args.block_time
            blk, cert = net.produce_height(t=t)
            if blk is None:
                print("round failed; rotating proposer", file=sys.stderr)
                continue
            produced += 1
            heights = {vn.app.height for vn in net.nodes}
            hashes = {vn.app.last_app_hash.hex()[:12] for vn in net.nodes}
            print(
                f"height {blk.header.height}: {len(blk.txs)} txs, "
                f"{len(cert.votes)} votes, nodes at {sorted(heights)}, "
                f"app hash {sorted(hashes)}",
                file=sys.stderr,
            )
            if args.blocks is None:
                time.sleep(args.block_time)
    except KeyboardInterrupt:
        pass
    finally:
        for svc in services:
            svc.shutdown()
        for vn in net.nodes:
            _quiesce(vn.app)
            vn.app.close()  # release writer flocks for follow-up commands
    final_hashes = {vn.app.last_app_hash for vn in net.nodes}
    if len(final_hashes) != 1:
        print(
            f"DIVERGENCE: {sorted(h.hex() for h in final_hashes)}",
            file=sys.stderr,
        )
        return 1
    print(json.dumps({
        "validators": n,
        "blocks": produced,
        "final_height": net.nodes[0].app.height,
        "app_hash": net.nodes[0].app.last_app_hash.hex(),
    }))
    return 0


def _write_snapshot_files(manifest: dict, chunks: list, out_dir: str) -> None:
    """Persist already-captured snapshot chunks + manifest — ONE writer
    (chain/sync.write_snapshot_dir, manifest last + fsync'd, so a
    half-written snapshot is never restorable) shared with the sync
    plane's interval-snapshot hook and the /sync/* serving store."""
    from celestia_app_tpu_torch.chain import sync as sync_mod

    sync_mod.write_snapshot_dir(manifest, chunks, out_dir)


def _write_snapshot(app, out_dir: str) -> dict:
    """One-shot capture + write for `snapshot create` (no concurrent
    mutator). The start loop splits capture/encode around its service
    lock and calls _write_snapshot_files directly."""
    from celestia_app_tpu_torch.chain import consensus

    manifest, chunks = consensus.snapshot_app_chunks(app)
    _write_snapshot_files(manifest, chunks, out_dir)
    return manifest


def _prune_snapshots(root: str, keep: int) -> None:
    """Keep-recent pruning, delegated to the sync plane's ONE
    implementation (chain/sync.prune_snapshots; default_overrides.go:
    294-297 semantics, 0 = keep everything)."""
    from celestia_app_tpu_torch.chain import sync as sync_mod

    sync_mod.prune_snapshots(root, keep)


def cmd_snapshot(args) -> int:
    """State-sync snapshots (cmd/root.go snapshot commands +
    default_overrides.go:294-297 semantics): `create` writes the committed
    state as verified chunks; `restore` bootstraps a FRESH home from them,
    verifying every chunk hash and the final app hash against the manifest
    before adopting anything."""
    from celestia_app_tpu_torch.chain import consensus

    if args.action == "create":
        app, _ = _make_app(args.home, args.device)
        manifest = _write_snapshot(app, args.out)
        print(json.dumps({
            "height": manifest["height"],
            "chunks": manifest["n_chunks"],
            "app_hash": manifest["app_hash"],
        }))
        return 0

    # restore into a fresh home (init must have been run for config/genesis)
    with open(os.path.join(args.out, "manifest.json")) as f:
        manifest = json.load(f)
    chunks = []
    for i in range(manifest["n_chunks"]):
        with open(os.path.join(args.out, f"chunk_{i:06d}.json"), "rb") as f:
            chunks.append(f.read())
    app, _ = _make_app(args.home, args.device)
    consensus.state_sync_bootstrap(app, manifest, chunks)
    app.persist_identity()
    print(json.dumps({
        "restored_height": app.height,
        "app_hash": app.last_app_hash.hex(),
    }))
    return 0


def cmd_das(args) -> int:
    """Data availability sampling (da/sampling.py), two modes:

    --url: light-node check against a remote node. The DAH is fetched over
    HTTP, validated, and bound to a data root. With --trusted-root (a data
    root from a TRUSTED source — a light client following commit
    certificates, chain/light.py) the server cannot fabricate a block:
    withholding, tampering, and a wrong DAH all fail. Without it the root
    comes from the server's own header (trust-on-first-use; the report
    carries "header_trusted": false) and only withholding/inconsistency
    within the served block is detectable.

    --home: local self-audit of a stored block — the square is rebuilt and
    revalidated against the stored header (disk corruption surfaces as
    unavailable, not a traceback)."""
    import numpy as np

    from celestia_app_tpu_torch.da import sampling

    if args.samples < 1:
        print("error: --samples must be >= 1", file=sys.stderr)
        return 2
    if bool(args.url) == bool(args.home):
        print("error: das needs exactly one of --home or --url",
              file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    header_trusted = True

    def _unavailable(height, msg):
        print(json.dumps({
            "height": height, "available": False, "error": msg,
        }, indent=2))
        return 1

    if args.url:
        import base64 as b64

        from celestia_app_tpu_torch.client.tx_client import HttpNodeClient
        from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
        from celestia_app_tpu_torch.utils import nmt_host

        remote = HttpNodeClient(args.url)
        height = args.height
        try:
            if height is None:
                height = remote.status()["height"]
            dah_doc = remote._post(
                "/abci_query", {"path": "custom/dah",
                                "data": {"height": height}}
            )
            dah = DataAvailabilityHeader(
                row_roots=tuple(
                    bytes.fromhex(x) for x in dah_doc["row_roots"]
                ),
                col_roots=tuple(
                    bytes.fromhex(x) for x in dah_doc["col_roots"]
                ),
            )
            # structural validation of UNTRUSTED input before anything
            # touches it (bounds, root shapes — dah.validate_basic)
            dah.validate_basic()
        except (OSError, ValueError, KeyError) as e:
            return _unavailable(height, f"fetching DAH failed: {e}")
        if args.trusted_root:
            root_hex = args.trusted_root.lower()
        else:
            header_trusted = False  # bound only to the server's own header
            try:
                from celestia_app_tpu_torch.net import transport

                root_hex = transport.request_json(
                    remote.base_url, f"/block/{height}", timeout=30
                )["data_hash"]
            except (OSError, ValueError, KeyError) as e:
                return _unavailable(height, f"fetching header failed: {e}")
        if dah.hash().hex() != root_hex:
            return _unavailable(
                height, "served DAH does not bind to the data root"
            )

        def fetch_cell(row, col):
            out = remote._post(
                "/abci_query",
                {"path": "custom/sampleCell",
                 "data": {"height": height, "row": row, "col": col}},
            )
            proof = nmt_host.NmtRangeProof(
                start=out["proof"]["start"],
                end=out["proof"]["end"],
                total=out["proof"]["total"],
                nodes=[b64.b64decode(n) for n in out["proof"]["nodes"]],
            )
            return b64.b64decode(out["share"]), proof
    else:
        from celestia_app_tpu_torch.chain.query import QueryError, QueryRouter

        app, _cfg = _make_app(args.home, args.device)
        router = QueryRouter(app)
        height = args.height if args.height is not None else app.height
        try:
            prover, root = router.prover_for(height)
        except (QueryError, FileNotFoundError, KeyError, ValueError) as e:
            # corrupted/missing stored block = unavailable, not a crash
            print(json.dumps({
                "height": height, "available": False, "error": str(e),
            }, indent=2))
            return 1
        dah, fetch_cell, root_hex = prover.dah, prover.prove_cell, root.hex()

    rep = sampling.sample_block(dah, fetch_cell, args.samples, rng)
    print(json.dumps({
        "height": height,
        "data_root": root_hex,
        "header_trusted": header_trusted,
        "samples": rep.samples,
        "verified": rep.verified,
        "failed": rep.failed,
        "available": rep.available,
        "confidence": round(rep.confidence, 6),
    }, indent=2))
    return 0 if rep.available else 1


def cmd_keys(args) -> int:
    from celestia_app_tpu_torch.chain.crypto import PrivateKey
    from celestia_app_tpu_torch.wire import bech32

    pk = PrivateKey.from_seed(args.seed.encode())
    pub = pk.public_key()
    print(json.dumps({
        "address": pub.address().hex(),
        "bech32": bech32.encode(pub.address()),
        "pubkey": pub.compressed.hex(),
    }, indent=2))
    return 0


def cmd_addr_conversion(args) -> int:
    """cmd/root.go addr-conversion: bech32 <-> hex for celestia addresses."""
    from celestia_app_tpu_torch.wire import bech32

    a = args.address
    if a.startswith("celestia"):
        pos = a.rfind("1")
        hrp = a[:pos]
        raw = bech32.decode(a, hrp)
        print(json.dumps({"hex": raw.hex(), "bech32": a}))
    else:
        raw = bytes.fromhex(a)
        print(json.dumps({
            "hex": a,
            "bech32": bech32.encode(raw),
            "valoper": bech32.encode(raw, bech32.HRP_VALOPER),
        }))
    return 0


def cmd_rollback(args) -> int:
    app, _ = _make_app(args.home, args.device)
    app.load_height(args.height)
    app.persist_identity()  # point LATEST back so starts resume here
    print(f"rolled back to height {app.height}")
    return 0


def cmd_export(args) -> int:
    app, _ = _make_app(args.home, args.device)
    print(json.dumps(app.export_genesis(), indent=2, sort_keys=True))
    return 0


def cmd_blocktime(args) -> int:
    from celestia_app_tpu_torch.tools import blocktime

    print(json.dumps(blocktime.report(os.path.join(args.home, "data"), args.last), indent=2))
    return 0


def cmd_blockscan(args) -> int:
    from celestia_app_tpu_torch.tools import blockscan

    for row in blockscan.scan(os.path.join(args.home, "data")):
        print(json.dumps(row))
    return 0


def cmd_timeline(args) -> int:
    """Cross-node span waterfall (tools/timeline.py): scrape
    /trace/spans from every node of a devnet, merge by the deterministic
    per-height trace ids, render per-height timelines (or dump JSON)."""
    from celestia_app_tpu_torch.tools import timeline

    return timeline.main(
        ["--nodes", args.nodes]
        + (["--height", str(args.height)] if args.height is not None else [])
        + (["--since", str(args.since)] if args.since else [])
        + ["--limit", str(args.limit), "--last", str(args.last)]
        + (["--json"] if args.json else [])
        + (["--no-xfer"] if getattr(args, "no_xfer", False) else [])
    )


def cmd_fleetmon(args) -> int:
    """Fleet-wide SLO verdict (tools/fleetmon.py): scrape every node,
    evaluate the declarative rule file, print one deterministic verdict
    JSON; exit code 2 on violation so CI can gate on it."""
    from celestia_app_tpu_torch.tools import fleetmon

    return fleetmon.main(
        ["--nodes", args.nodes, "--rules", args.rules]
        + (["--no-availability"] if args.no_availability else [])
        + (["--out", args.out] if args.out else [])
    )


def cmd_txsim(args) -> int:
    from celestia_app_tpu_torch.chain.crypto import PrivateKey
    from celestia_app_tpu_torch.chain.node import Node
    from celestia_app_tpu_torch.client.tx_client import Signer
    from celestia_app_tpu_torch.tools import txsim

    from celestia_app_tpu_torch import appconsts as _consts

    if args.url:
        return _txsim_load(args)
    if not args.home:
        print("ERROR: txsim needs --home (paced mode) or --url "
              "(sustained-load mode)", file=sys.stderr)
        return 1
    app, cfg = _make_app(args.home, args.device)
    node = Node(app, **_mempool_kwargs(cfg))
    from celestia_app_tpu_torch.chain.state import Context, InfiniteGasMeter

    ctx = Context(app.store, InfiniteGasMeter(), app.height, 0,
                  app.chain_id, app.app_version)
    signer = Signer(app.chain_id)
    accounts = []
    for i in range(args.accounts):
        # seeds are the decimal strings "0", "1", ... so `keys derive 0`
        # prints the matching address for genesis funding
        pk = PrivateKey.from_seed(str(i).encode())
        addr = pk.public_key().address()
        acc = app.auth.account(ctx, addr)
        number = acc["number"] if acc else i
        sequence = acc["sequence"] if acc else 0
        signer.add_account(pk, number, sequence)
        accounts.append(addr)
    validators = None
    if args.stake_sequences:
        validators = [op for op, _p in app.staking.validators(ctx)]
    rep = txsim.run(
        node, signer, accounts,
        rounds=args.rounds,
        blob_sequences=args.blob_sequences,
        send_sequences=args.send_sequences,
        stake_sequences=args.stake_sequences,
        blob_sizes=tuple(int(x) for x in args.blob_sizes.split("-")),
        blobs_per_pfb=tuple(int(x) for x in args.blobs_per_pfb.split("-")),
        validators=validators,
    )
    print(json.dumps(rep.as_dict(), indent=2))
    return 0


def _txsim_load(args) -> int:
    """Sustained-load txsim against a live devnet (tools/txsim.run_load):
    N concurrent sequences over persistent keep-alive connections, each
    confirm-polling its txs to commit. Accounts are the standard derive
    keys ("0", "1", ...), resolved against the node's auth state — fund
    them first (`init` funds 0..9 by default)."""
    from celestia_app_tpu_torch.chain.crypto import PrivateKey
    from celestia_app_tpu_torch.client.tx_client import HttpNodeClient, Signer
    from celestia_app_tpu_torch.tools import txsim

    probe = HttpNodeClient(args.url[0])
    status = probe.status()
    signer = Signer(status["chain_id"])
    accounts = []
    n_seq = args.blob_sequences + args.send_sequences
    for i in range(max(args.accounts, n_seq)):
        pk = PrivateKey.from_seed(str(i).encode())
        addr = pk.public_key().address()
        out = probe._post("/abci_query", {"path": "auth/account",
                                          "data": {"address": addr.hex()}})
        acc = out.get("account")
        if acc is None:
            print(f"ERROR: derive key {i} ({addr.hex()}) has no funded "
                  f"account on the node; fund it first", file=sys.stderr)
            probe.close()
            return 1
        signer.add_account(pk, acc["number"], acc["sequence"])
        accounts.append(addr)
    probe.close()
    lo, hi = (float(x) for x in args.gas_prices.split("-"))
    cfg = txsim.LoadConfig(
        blob_sequences=args.blob_sequences,
        send_sequences=args.send_sequences,
        txs_per_sequence=args.txs_per_sequence,
        blob_sizes=tuple(int(x) for x in args.blob_sizes.split("-")),
        blobs_per_pfb=tuple(int(x) for x in args.blobs_per_pfb.split("-")),
        gas_prices=(lo, hi),
        seed=args.seed,
        confirm_timeout_s=args.confirm_timeout,
    )
    rep = txsim.run_load(args.url, signer, accounts, cfg)
    print(json.dumps(rep.as_dict(), indent=2))
    return 0


def cmd_dasload(args) -> int:
    """Serving-plane load harness (tools/dasload.py): drive N concurrent
    persistent-connection samplers at a devnet's /das/* surface and
    print the JSON report (samples_per_sec, p99_ms, pack_hit_ratio)."""
    from celestia_app_tpu_torch.tools import dasload

    argv = ["--url", args.url, "--samplers", str(args.samplers),
            "--requests", str(args.requests), "--cells", str(args.cells),
            "--mode", args.mode]
    if args.heights:
        argv += ["--heights", args.heights]
    return dasload.main(argv)


def cmd_blobload(args) -> int:
    """Read-plane load harness (tools/blobload.py): drive N concurrent
    persistent-connection namespace readers at a devnet's /blob/*
    surface and print the JSON report (namespace_queries_per_sec,
    p99_ms, present_ratio, pack_hit_ratio)."""
    from celestia_app_tpu_torch.tools import blobload

    argv = ["--url", args.url, "--readers", str(args.readers),
            "--requests", str(args.requests), "--mode", args.mode,
            "--batch", str(args.batch)]
    if args.heights:
        argv += ["--heights", args.heights]
    if args.namespaces:
        argv += ["--namespaces", args.namespaces]
    return blobload.main(argv)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="celestia_app_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    # every command takes --device (resolved by _resolve_device)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument(
        "--device", default=None,
        help="torch device: cuda (the card, the default), cpu (the plain "
             "path) or mesh (the card, with the mesh plane over every "
             "visible card); default: the home's config.json device, else "
             "cuda")

    def leaf(group, name, **kw):
        return group.add_parser(name, parents=[common], **kw)

    p = leaf(sub, "init")
    p.add_argument("--home", required=True)
    p.add_argument("--chain-id", default="celestia-tpu-1")
    p.add_argument("--account", action="append")
    p.add_argument("--validator", action="append")
    p.set_defaults(fn=cmd_init)

    p = leaf(sub, "start")
    p.add_argument("--home", required=True)
    p.add_argument("--listen", type=int, default=26658)
    p.add_argument("--block-time", type=float, default=6.0)
    p.add_argument("--blocks", type=int, default=None)
    p.add_argument("--trace", action="store_true",
                   help="append every committed store write/delete to "
                        "data/store_trace.jsonl (SetCommitMultiStoreTracer "
                        "analog)")
    p.set_defaults(fn=cmd_start)

    p = leaf(sub, "status")
    p.add_argument("--home", required=True)
    p.set_defaults(fn=cmd_status)

    p = leaf(sub, "query")
    p.add_argument("--home", required=True)
    p.add_argument("path")
    p.add_argument("data", nargs="?")
    p.set_defaults(fn=cmd_query)

    p = leaf(sub, "tx")
    p.add_argument("action",
                   choices=["send", "pay-for-blob", "create-validator"])
    p.add_argument("--home", required=True)
    p.add_argument("--from-seed", required=True,
                   help="key seed (matches `keys derive`)")
    p.add_argument("--to", help="recipient address hex (send)")
    p.add_argument("--amount", help="utia amount (send)")
    p.add_argument("--namespace", help="10-hex-char v0 namespace id (pfb)")
    p.add_argument("--data", help="blob hex, or @file for raw bytes (pfb)")
    p.add_argument("--input-file",
                   help="multi-blob JSON file (reference --input-file "
                        "schema: {\"Blobs\": [{\"namespaceID\": \"0x..\", "
                        "\"blob\": \"0x..\"}]})")
    p.set_defaults(fn=cmd_tx)

    p = leaf(sub, "devnet")
    p.add_argument("--home", required=True)
    p.add_argument("--chain-id", default="celestia-devnet-1")
    p.add_argument("--validators", type=int, default=3)
    p.add_argument("--blocks", type=int, default=None)
    p.add_argument("--block-time", type=float, default=1.0)
    p.add_argument("--load", action="store_true",
                   help="submit a send per block (txsim-lite)")
    p.add_argument("--processes", action="store_true",
                   help="one OS process per validator; consensus over sockets")
    p.add_argument("--autonomous", action="store_true",
                   help="with --processes: no coordinator — each validator "
                        "runs its own consensus reactor and gossips "
                        "proposals/votes/txs peer-to-peer")
    p.set_defaults(fn=cmd_devnet)

    p = leaf(
        sub,
        "da-serve",
        help="standalone DA-core service for foreign nodes (§7.1.7 "
             "shim): /da/extend_commit + /da/prove_shares, no chain "
             "attached")
    p.add_argument("--listen", type=int, default=26659)
    p.set_defaults(fn=cmd_da_serve)

    p = leaf(
        sub,
        "das-serve",
        help="DAS sample-proof server over a node home (das/server.py): "
             "GET /das/sample + batched POST /das/samples from committed "
             "blocks — the full-node half of the DAS plane")
    p.add_argument("--home", required=True)
    p.add_argument("--listen", type=int, default=26660)
    p.add_argument("--cache-heights", type=int, default=4,
                   help="LRU square-cache depth (per-height row trees)")
    p.add_argument("--no-packs", action="store_true",
                   help="disable static proof-pack serving (GET /das/pack"
                        "*) even when <home>/packs holds packs")
    p.set_defaults(fn=cmd_das_serve)

    p = leaf(
        sub,
        "blob-serve",
        help="read-plane sidecar over a node home (das/blob_server.py): "
             "GET /blob/get + batched POST /blob/namespaces + static "
             "blob-pack chunks for rollup readers")
    p.add_argument("--home", required=True)
    p.add_argument("--listen", type=int, default=26661)
    p.add_argument("--cache-heights", type=int, default=4,
                   help="LRU square-cache depth (per-height row trees)")
    p.add_argument("--no-packs", action="store_true",
                   help="disable static blob-pack serving (GET /blob/pack"
                        "*) even when <home>/blobpacks holds packs")
    p.set_defaults(fn=cmd_blob_serve)

    p = leaf(
        sub,
        "das-follow",
        help="DASer light-node daemon (das/daser.py): follow headers by "
             "commit certificate, sample every height, checkpoint under "
             "--home/das/, halt on a verified bad-encoding fraud proof")
    p.add_argument("--home", required=True,
                   help="holds genesis.json (the trust root) and the "
                        "das/checkpoint.json progress record")
    p.add_argument("--chain-id", default="celestia-tpu-1")
    p.add_argument("--peer", action="append",
                   help="sampling/header peer URL (repeatable)")
    p.add_argument("--samples", type=int, default=16,
                   help="cells sampled per header (confidence 1-(3/4)^s)")
    p.add_argument("--workers", type=int, default=3,
                   help="parallel catch-up workers")
    p.add_argument("--interval", type=float, default=1.0,
                   help="seconds between sweeps")
    p.add_argument("--seed", type=int, default=None,
                   help="sampling rng seed (default: fresh entropy)")
    p.add_argument("--once", action="store_true",
                   help="exit 0 once caught up to the served head")
    p.add_argument("--no-packs", action="store_true",
                   help="never fetch advertised proof-pack chunks; "
                        "sample via live /das/samples only")
    p.set_defaults(fn=cmd_das_follow)

    p = leaf(
        sub,
        "blob-follow",
        help="rollup follower daemon (client/follower.py): track one "
             "namespace as a verifying light client — certified "
             "headers, checked inclusion/absence proofs, checkpoint "
             "under --home/blob/")
    p.add_argument("--home", required=True,
                   help="holds genesis.json (the trust root) and the "
                        "blob/checkpoint.json progress record")
    p.add_argument("--chain-id", default="celestia-tpu-1")
    p.add_argument("--peer", action="append",
                   help="serving peer URL (repeatable)")
    p.add_argument("--namespace", required=True,
                   help="29-byte namespace hex to follow")
    p.add_argument("--interval", type=float, default=1.0,
                   help="seconds between sweeps")
    p.add_argument("--once", action="store_true",
                   help="exit 0 once caught up to the served head")
    p.add_argument("--no-packs", action="store_true",
                   help="never read advertised blob-pack chunks; resolve "
                        "via live /blob/get only")
    p.set_defaults(fn=cmd_blob_follow)

    p = leaf(
        sub,
        "verify",
        help="blobstream verify (x/blobstream client verify analog): "
             "prove shares at a height up to the covering data-commitment "
             "attestation's tuple root")
    p.add_argument("--home", required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--start", type=int, default=0,
                   help="ODS share start index (row-major)")
    p.add_argument("--end", type=int, default=1, help="exclusive end index")
    p.add_argument("--namespace",
                   help="29-byte namespace hex (default: share 0's)")
    p.set_defaults(fn=cmd_verify)

    p = leaf(
        sub, "multihost-dryrun",
        help="prove the cross-host path: N worker processes x M seq shards "
             "as ONE global mesh (torch.distributed over gloo), sharded "
             "pipeline, every host checking the mesh's roots against the "
             "one-device pipeline")
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--devices-per-host", type=int, default=4)
    p.add_argument("--k", type=int, default=16)
    p.add_argument("--batch", type=int, default=2)
    p.set_defaults(fn=cmd_multihost_dryrun)

    p = leaf(sub, "multihost-worker")  # internal (spawned)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--k", type=int, required=True)
    p.add_argument("--batch", type=int, required=True)
    p.add_argument("--devices-per-host", type=int, required=True)
    p.set_defaults(fn=cmd_multihost_worker)

    p = leaf(
        sub,
        "e2e-bench",
        help="throughput benchmark over the autonomous process devnet "
             "(the reference test/e2e/benchmark analog: PFB flood, "
             "injected gossip latency, BlockSummary scrape, >=90%%-of-"
             "target pass criterion)")
    p.add_argument("--home", required=True)
    p.add_argument("--chain-id", default="celestia-e2e-bench")
    p.add_argument("--validators", type=int, default=2)
    p.add_argument("--blocks", type=int, default=8)
    p.add_argument("--block-time", type=float, default=1.0)
    p.add_argument("--blob-kb", type=int, default=200,
                   help="per-blob size (reference floods 200 KB blobs)")
    p.add_argument("--blobs-per-tx", type=int, default=2)
    p.add_argument("--txs-per-block", type=int, default=4,
                   help="load pacing: PFBs submitted per committed height "
                        "(txsim's per-sequence-per-block pacing; the "
                        "default 4 x 400 KB fills the 1.97 MB default "
                        "square without flooding the mempool cap)")
    p.add_argument("--latency-ms", type=float, default=70.0,
                   help="injected per-message gossip latency "
                        "(BitTwister's 70 ms in the reference manifests)")
    p.add_argument("--target-mb", type=float, default=1.0,
                   help="pass if some block >= 90%% of this "
                        "(TwoNodeSimple criterion: 1 MB)")
    p.set_defaults(fn=cmd_e2e_bench)

    p = leaf(sub, "validator-serve",
             help="one validator process: HTTP consensus service")
    p.add_argument("--home", required=True,
                   help="validator home (genesis.json + key.json inside)")
    p.add_argument("--chain-id", required=True)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--http", type=int, default=None,
                   help="also serve the node HTTP query surface (status/"
                        "block/abci_query/trace/metrics; 0 = ephemeral)")
    p.add_argument("--autonomous", action="store_true",
                   help="run the consensus reactor in-process: wait for "
                        "<home>/peers.json, then drive rounds by gossiping "
                        "with those peers (no external orchestrator)")
    p.set_defaults(fn=cmd_validator_serve)

    p = leaf(sub, "addr-conversion")
    p.add_argument("address", help="bech32 celestia1.../hex address")
    p.set_defaults(fn=cmd_addr_conversion)

    p = sub.add_parser("genesis", help="genesis file toolkit (genutil analog)")
    gsub = p.add_subparsers(dest="gcmd", required=True)
    g = leaf(gsub, "add-account")
    g.add_argument("--home", required=True)
    g.add_argument("--address", required=True, help="20-byte hex address")
    g.add_argument("--balance", required=True, type=int)
    g.set_defaults(fn=cmd_genesis_add_account)
    g = leaf(gsub, "gentx")
    g.add_argument("--home", required=True)
    g.add_argument("--seed", required=True, help="key seed (as `keys`)")
    g.add_argument("--moniker", default="validator")
    g.add_argument("--power", required=True, type=int)
    g.set_defaults(fn=cmd_genesis_gentx)
    g = leaf(gsub, "collect-gentxs")
    g.add_argument("--home", required=True)
    g.set_defaults(fn=cmd_genesis_collect)
    g = leaf(gsub, "validate")
    g.add_argument("--home", required=True)
    g.set_defaults(fn=cmd_genesis_validate)

    p = leaf(sub, "config", help="get/set node-local config keys")
    p.add_argument("action", choices=["get", "set"])
    p.add_argument("key", nargs="?")
    p.add_argument("value", nargs="?")
    p.add_argument("--home", required=True)
    p.set_defaults(fn=cmd_config)

    p = leaf(sub, "download-genesis",
             help="fetch/verify a known network's genesis "
                  "against its pinned sha256")
    p.add_argument("chain_id", nargs="?", default="celestia")
    p.add_argument("--home", required=True)
    p.set_defaults(fn=cmd_download_genesis)

    p = leaf(sub, "snapshot")
    p.add_argument("action", choices=["create", "restore"])
    p.add_argument("--home", required=True)
    p.add_argument("--out", required=True, help="snapshot directory")
    p.set_defaults(fn=cmd_snapshot)

    p = leaf(sub, "das", help="sample a block's data availability")
    p.add_argument("--home", help="local self-audit of a stored block")
    p.add_argument("--url", help="light-node mode against a remote node")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--samples", type=int, default=16)
    p.add_argument("--trusted-root",
                   help="hex data root from a TRUSTED source (e.g. a light "
                        "client following certificates); binds the served "
                        "DAH so the server cannot fabricate the block")
    p.add_argument("--seed", type=int, default=None,
                   help="sampling entropy (default: OS randomness)")
    p.set_defaults(fn=cmd_das)

    p = leaf(sub, "keys")
    p.add_argument("action", choices=["derive"])
    p.add_argument("seed")
    p.set_defaults(fn=cmd_keys)

    p = leaf(sub, "rollback")
    p.add_argument("--home", required=True)
    p.add_argument("height", type=int)
    p.set_defaults(fn=cmd_rollback)

    p = leaf(sub, "export")
    p.add_argument("--home", required=True)
    p.set_defaults(fn=cmd_export)

    p = leaf(sub, "blocktime")
    p.add_argument("--home", required=True)
    p.add_argument("--last", type=int, default=None)
    p.set_defaults(fn=cmd_blocktime)

    p = leaf(
        sub,
        "timeline",
        help="cross-node span waterfall: scrape /trace/spans from every "
             "node, merge by trace_id, render per-height timelines",
    )
    p.add_argument("--nodes", required=True,
                   help="comma-separated node/validator service URLs")
    p.add_argument("--height", type=int, default=None,
                   help="only this height's trace")
    p.add_argument("--since", type=int, default=0)
    p.add_argument("--limit", type=int, default=10_000)
    p.add_argument("--last", type=int, default=5,
                   help="render the N most recent heights (text mode)")
    p.add_argument("--json", action="store_true",
                   help="dump merged spans as JSON")
    p.add_argument("--no-xfer", action="store_true",
                   help="skip the transfer-ledger rows (/trace/xfer)")
    p.set_defaults(fn=cmd_timeline)

    p = leaf(
        sub,
        "fleetmon",
        help="fleet-wide SLO verdict (tools/fleetmon.py): scrape "
             "/metrics + status from every node, evaluate a declarative "
             "rule file, exit 0 pass / 2 violation",
    )
    p.add_argument("--nodes", required=True,
                   help="comma-separated node/validator service URLs")
    p.add_argument("--rules", required=True,
                   help="SLO rule file (JSON, FORMATS §22.1)")
    p.add_argument("--no-availability", action="store_true",
                   help="skip the /das/availability scrape")
    p.add_argument("--out", default=None,
                   help="also write the verdict JSON to this file")
    p.set_defaults(fn=cmd_fleetmon)

    p = leaf(sub, "blockscan")
    p.add_argument("--home", required=True)
    p.set_defaults(fn=cmd_blockscan)

    p = leaf(
        sub,
        "txsim",
        help="tx load generator (tools/txsim.py): paced in-process "
             "rounds against --home, or the sustained-load engine "
             "(concurrent keep-alive sequences, confirm-polling) "
             "against a live devnet via --url")
    p.add_argument("--home",
                   help="paced mode: the node home to drive in-process")
    p.add_argument("--url", action="append", default=None,
                   help="load mode: devnet service URL (repeatable; "
                        "sequences round-robin over them)")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--accounts", type=int, default=3)
    p.add_argument("--blob-sequences", type=int, default=2)
    p.add_argument("--send-sequences", type=int, default=1)
    p.add_argument("--stake-sequences", type=int, default=0)
    p.add_argument("--blob-sizes", default="100-2000")
    p.add_argument("--blobs-per-pfb", default="1-3")
    p.add_argument("--txs-per-sequence", type=int, default=8,
                   help="load mode: txs each sequence submits")
    p.add_argument("--gas-prices", default="0.002-0.02",
                   help="load mode: uniform gas-price draw LO-HI")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--confirm-timeout", type=float, default=60.0)
    p.set_defaults(fn=cmd_txsim)

    p = leaf(
        sub,
        "dasload",
        help="serving-plane load harness (tools/dasload.py): thousands "
             "of concurrent persistent-connection samplers against a "
             "devnet's /das/* surface; prints the JSON report")
    p.add_argument("--url", required=True)
    p.add_argument("--samplers", type=int, default=1000)
    p.add_argument("--requests", type=int, default=3)
    p.add_argument("--cells", type=int, default=16)
    p.add_argument("--mode", choices=("live", "pack", "auto"),
                   default="auto")
    p.add_argument("--heights", default="",
                   help="comma-separated heights (default: last 8 below "
                        "the served head)")
    p.set_defaults(fn=cmd_dasload)

    p = leaf(
        sub,
        "blobload",
        help="read-plane load harness (tools/blobload.py): concurrent "
             "persistent-connection namespace readers against a devnet's "
             "/blob/* surface; prints the JSON report")
    p.add_argument("--url", required=True)
    p.add_argument("--readers", type=int, default=256)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--mode", choices=("single", "batch", "pack"),
                   default="batch")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--heights", default="",
                   help="comma-separated heights (default: last 4 below "
                        "the served head)")
    p.add_argument("--namespaces", default="",
                   help="comma-separated namespace hex (default: the "
                        "heights' packed namespaces)")
    p.set_defaults(fn=cmd_blobload)

    args = ap.parse_args(argv)
    args.device = _resolve_device(args)
    mark = len(_OPEN_APPS)  # only close what THIS invocation opens — tests
    try:                    # may hold apps from direct _make_app calls
        return args.fn(args)
    except BrokenPipeError:
        # stdout piped into a pager/head that exited: normal CLI etiquette
        # is a silent success, not a traceback
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0
    finally:
        while len(_OPEN_APPS) > mark:
            app = _OPEN_APPS.pop()()
            if app is not None:
                try:
                    _quiesce(app)
                    app.close()
                except Exception:
                    pass


if __name__ == "__main__":
    sys.exit(main())
