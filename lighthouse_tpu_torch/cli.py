"""The ``lighthouse-tpu`` command-line interface.

Equivalent of the reference's ``lighthouse`` binary (``lighthouse/src/main.rs:79-402``
clap tree): ``beacon_node`` (bn), ``validator_client`` (vc), and
``account_manager`` (am) subcommands over the same library stack the tests
drive.  ``python -m lighthouse_tpu_torch <subcommand> --help`` for usage.

A copy of the JAX package's ``lighthouse_tpu/cli.py`` on the port.  ``bn``
runs on the card by default (``--device cuda``; ``--device cpu`` runs the
CUDA kernels' plain versions) and exits non-zero before serving where there
is no card; its ``--bls-backend`` is ``torch`` (the card), ``host`` or
``fake``.  ``--aot-warmup`` sets ``LIGHTHOUSE_TPU_AOT_WARMUP``, as in the
JAX package: the builder then warms the standard verifier buckets on a
background thread, one neutral verify each
(``ops/compile_cache.maybe_warmup_from_env``).  ``lcli transition-bench``
runs the port's own ``python -m lighthouse_tpu_torch.transition_bench``.
"""

from __future__ import annotations

import argparse
import getpass
import json
import logging
import os
import signal
import sys
import threading
import time
from typing import List, Optional


def _spec_for(network: str):
    from .types.spec import SPECS

    if network not in SPECS:
        raise SystemExit(f"unknown network {network!r} (have: {', '.join(SPECS)})")
    return SPECS[network]()


def _write_secret_file(path: str, text: str) -> None:
    """Owner-only (0600) secret write — keys and tokens must never be
    world-readable."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(text)


def _read_password(path, prompt: str) -> str:
    if path:
        with open(path) as f:
            return f.read().strip()
    return getpass.getpass(prompt)


# ------------------------------------------------------------ beacon node


def run_beacon_node(args) -> int:
    from .client import ClientBuilder

    from .logs import get_logger, setup_logging

    setup_logging(
        logging.DEBUG if args.debug else logging.INFO,
        json_format=getattr(args, "log_json", False),
    )
    builder = ClientBuilder()
    try:
        builder.with_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"beacon node: {e}")
    if getattr(args, "testnet_dir", None):
        from .network_config import Eth2NetworkConfig

        spec = Eth2NetworkConfig.from_testnet_dir(args.testnet_dir).spec
    else:
        spec = _spec_for(args.network)
    if getattr(args, "aot_warmup", False):
        # The builder's warmup hook reads the env flag; the CLI flag is just
        # its spelled-out form.
        os.environ["LIGHTHOUSE_TPU_AOT_WARMUP"] = "1"
    builder.with_spec(spec).with_bls_backend(args.bls_backend)
    if getattr(args, "checkpoint_sync_url", None):
        builder.with_checkpoint_sync(args.checkpoint_sync_url)
    elif args.interop_validators:
        builder.with_interop_genesis(
            args.interop_validators, genesis_time=args.interop_genesis_time
        )
    elif args.genesis_state:
        from .types.containers import build_types

        types = build_types(spec.preset)
        fork = spec.fork_name_at_epoch(0)
        with open(args.genesis_state, "rb") as f:
            raw = f.read()
        t = time.perf_counter()
        builder.with_genesis_state(types.state[fork].from_ssz_bytes(raw))
        get_logger("cli").info("genesis state: %d bytes decoded as %s in %.2f s",
                               len(raw), fork, time.perf_counter() - t)
    else:
        raise SystemExit("provide --checkpoint-sync-url URL, "
                         "--interop-validators N or --genesis-state FILE")
    if args.datadir:
        builder.with_datadir(args.datadir)
    if args.execution_endpoint:
        if not args.execution_jwt:
            raise SystemExit("--execution-endpoint requires --execution-jwt FILE")
        from .execution_layer.auth import strip_prefix

        with open(args.execution_jwt) as f:
            builder.with_execution_layer(args.execution_endpoint, strip_prefix(f.read()))
    builder.with_http_api(args.http_port)
    if args.slasher:
        builder.with_slasher()
    if getattr(args, "monitoring_endpoint", None):
        builder.with_monitoring(args.monitoring_endpoint)
    if args.listen_port is not None or args.peers or args.boot_nodes:
        builder.with_network(
            listen_port=args.listen_port or 0,
            peers=[p for p in (args.peers or "").split(",") if p],
            boot_nodes=[b for b in (args.boot_nodes or "").split(",") if b],
        )

    client = builder.build().start()
    port = client.http_server.url.rsplit(":", 1)[1]
    print(f"beacon node up: http API on :{port}, "
          f"network={args.network}, backend={args.bls_backend}, device={args.device}",
          flush=True)
    _wait_for_shutdown()
    client.stop()
    return 0


# -------------------------------------------------------- validator client


def run_validator_client(args) -> int:
    from .crypto import keystore as ks
    from .http_api import BeaconNodeHttpClient
    from .types.containers import build_types
    from .validator_client import SlashingProtectionDB, ValidatorClient

    from .logs import setup_logging

    setup_logging(logging.INFO)
    spec = _spec_for(args.network)
    types = build_types(spec.preset)

    password = _read_password(args.password_file, "keystore password: ")
    keys = []
    for name in sorted(os.listdir(args.keystore_dir)):
        if not name.endswith(".json"):
            continue
        keystore = ks.load_json(os.path.join(args.keystore_dir, name))
        if "crypto" not in keystore or "pubkey" not in keystore:
            continue
        keys.append(ks.load_keystore_signing_key(keystore, password))
    if not keys:
        raise SystemExit(f"no keystores found under {args.keystore_dir}")
    print(f"loaded {len(keys)} validator keys")

    clients = [BeaconNodeHttpClient(u) for u in args.beacon_nodes.split(",")]
    genesis = clients[0].genesis()
    slashing_db = SlashingProtectionDB()
    if args.slashing_protection_db:
        from .store.lockbox_store import LockboxStore

        slashing_db = SlashingProtectionDB(
            store=LockboxStore(args.slashing_protection_db)
        )
    vc = ValidatorClient(
        keys=keys,
        beacon_nodes=clients,
        spec=spec,
        types=types,
        genesis_validators_root=bytes.fromhex(genesis["genesis_validators_root"][2:]),
        slashing_db=slashing_db,
    )
    keymanager = None
    if getattr(args, "keymanager_port", None) is not None:
        from .validator_client.keymanager import KeymanagerServer

        keymanager = KeymanagerServer(
            store=vc.store,
            genesis_validators_root=vc.store.genesis_validators_root,
            port=args.keymanager_port,
            preparation=vc.preparation, blocks=vc.blocks,
        ).start()
        token_path = os.path.join(args.keystore_dir, "api-token.txt")
        # owner-only: the token grants key deletion/import (reference writes
        # api-token.txt 0600)
        _write_secret_file(token_path, keymanager.token)
        print(f"keymanager API on {keymanager.url} (token in {token_path})")
    print("validator client running (ctrl-c to stop)")
    try:
        vc.run_forever(genesis_time=int(genesis["genesis_time"]))
    except KeyboardInterrupt:
        pass
    finally:
        if keymanager is not None:
            keymanager.stop()
    return 0


# -------------------------------------------------------- account manager


def run_account(args) -> int:
    from .crypto import keystore as ks

    os.makedirs(args.base_dir, exist_ok=True)
    if args.account_cmd == "wallet-create":
        password = _read_password(args.password_file, "wallet password: ")
        wallet, _seed = ks.create_wallet(args.name, password)
        path = os.path.join(args.base_dir, f"wallet-{args.name}.json")
        ks.save_json(wallet, path)
        print(f"wallet written to {path}")
        return 0
    if args.account_cmd == "validator-create":
        wallet = ks.load_json(args.wallet)
        wpass = _read_password(args.password_file, "wallet password: ")
        kpass = _read_password(args.keystore_password_file, "keystore password: ")
        out_dir = os.path.join(args.base_dir, "validators")
        os.makedirs(out_dir, exist_ok=True)
        derived = ks.derive_validator_keystores(wallet, wpass, kpass, args.count)
        for keystore, _sk in derived:
            path = os.path.join(out_dir, f"keystore-{keystore['pubkey'][:16]}.json")
            ks.save_json(keystore, path)
            print(f"validator {keystore['pubkey'][:16]}… -> {path}")
        ks.save_json(wallet, args.wallet)  # persists nextaccount
        return 0
    if args.account_cmd == "validator-list":
        vdir = os.path.join(args.base_dir, "validators")
        if not os.path.isdir(vdir):
            print("no validators")
            return 0
        for name in sorted(os.listdir(vdir)):
            if name.endswith(".json"):
                obj = ks.load_json(os.path.join(vdir, name))
                print(f"0x{obj.get('pubkey', '')}  path={obj.get('path', '')}")
        return 0
    if args.account_cmd == "slashing-protection-export":
        from .store.lockbox_store import LockboxStore
        from .validator_client import SlashingProtectionDB

        db = SlashingProtectionDB(store=LockboxStore(args.db))
        text = db.export_json(bytes.fromhex(args.genesis_validators_root[2:]))
        with open(args.out, "w") as f:
            f.write(text)
        print(f"interchange written to {args.out}")
        return 0
    if args.account_cmd == "slashing-protection-import":
        from .store.lockbox_store import LockboxStore
        from .validator_client import SlashingProtectionDB

        db = SlashingProtectionDB(store=LockboxStore(args.db))
        n = db.import_json(
            open(args.interchange).read(),
            bytes.fromhex(args.genesis_validators_root[2:]),
        )
        print(f"imported protection for {n} validators")
        return 0
    raise SystemExit(f"unknown account command {args.account_cmd}")


# ---------------------------------------------------------------- parser


def run_database_manager(args) -> int:
    """``lighthouse db`` equivalent (reference ``database_manager/``):
    inspect / version / compact an on-disk node database."""
    from .store.kv import DBColumn
    from .store.lockbox_store import LockboxStore

    path = os.path.join(args.datadir, "chain.db")
    if not os.path.exists(path):
        print(f"no database at {path}", file=sys.stderr)
        return 1
    store = LockboxStore(path)
    try:
        if args.db_cmd == "version":
            import struct

            raw = store.get(DBColumn.BEACON_META, b"schema")
            version = struct.unpack(">Q", raw)[0] if raw else None
            print(json.dumps({"path": path, "schema_version": version}))
        elif args.db_cmd == "inspect":
            counts = {}
            names = {
                getattr(DBColumn, n): n for n in dir(DBColumn) if not n.startswith("_")
            }
            for column in names:
                n_keys = sum(1 for _ in store.iter_column(column))
                if n_keys:
                    counts[names[column]] = n_keys
            print(json.dumps({"path": path, "keys_per_column": counts}))
        elif args.db_cmd == "compact":
            store.compact()
            print(json.dumps({"path": path, "compacted": True}))
        elif args.db_cmd == "prune-payloads":
            # Reference `lighthouse db prune-payloads`: rewrite stored
            # post-merge blocks WITHOUT their execution payloads — the
            # block streamer reconstructs them from the EL on read.
            from .chain.block_streamer import blind_signed_block
            from .store.hot_cold import decode_stored_block, encode_stored_block
            from .types.containers import build_types

            spec = _spec_for(args.network)
            types = build_types(spec.preset)
            pruned = skipped = 0
            # iter_column snapshots its key list up front, so rewriting
            # entries mid-iteration is safe without materializing every
            # block's bytes at once
            for key, raw in store.iter_column(DBColumn.BEACON_BLOCK):
                signed, is_blinded, _fork = decode_stored_block(types, raw)
                if is_blinded or not hasattr(
                        signed.message.body, "execution_payload"):
                    skipped += 1  # payload-free already, or pre-merge
                    continue
                blinded = blind_signed_block(signed, types)
                store.put(DBColumn.BEACON_BLOCK, key,
                          encode_stored_block(blinded, blinded=True))
                pruned += 1
            print(json.dumps({"path": path, "payloads_pruned": pruned,
                              "skipped": skipped}))
        elif args.db_cmd == "prune-blobs":
            # Reference `lighthouse db prune-blobs`: drop sidecars below the
            # retention horizon (--before-slot; the node's own periodic
            # pruning uses the spec MIN_EPOCHS_FOR_BLOB_SIDECARS horizon).
            from .store.hot_cold import prune_blob_column
            from .types.containers import build_types

            spec = _spec_for(args.network)
            types = build_types(spec.preset)
            pruned = prune_blob_column(store, types, args.before_slot)
            print(json.dumps({"path": path, "blob_sets_pruned": pruned}))
    finally:
        store.close()
    return 0


def run_lcli(args) -> int:
    """Dev swiss-army knife (reference ``lcli/``): state-transition timing
    loops, root computation, SSZ inspection."""
    from .types.containers import build_types

    if args.lcli_cmd == "transition-bench":
        import subprocess

        cmd = [sys.executable, "-m", "lighthouse_tpu_torch.transition_bench",
               "--validators", str(args.validators)]
        if args.slots:
            cmd += ["--slots", str(args.slots)]
        for _ in range(args.runs):
            subprocess.run(cmd, check=True, cwd=os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
        return 0

    if args.lcli_cmd == "generate-bootnode-enr":
        # Reference `lcli generate-bootnode-enr`: mint a bootnode identity —
        # a fresh secp256k1 key + the signed ENR advertising ip/udp/tcp —
        # into an output dir (refusing to clobber an existing one).
        from .network.discv5 import KeyPair
        from .network.discv5.enr import ENR, EnrError

        if os.path.exists(args.output_dir):
            raise SystemExit(f"{args.output_dir} already exists, will not override")
        keypair = KeyPair()
        try:
            # build (validating the ip) BEFORE creating the directory: a
            # failure must not leave a half-made dir the clobber guard
            # then refuses on the corrected rerun
            enr = ENR.build(keypair, seq=1, ip=args.ip,
                            udp=args.udp_port, tcp=args.tcp_port)
        except (ValueError, EnrError) as e:
            raise SystemExit(f"cannot build ENR: {e}")
        os.makedirs(args.output_dir)
        with open(os.path.join(args.output_dir, "enr.dat"), "w") as f:
            f.write(enr.to_text())
        # fixed-width 32-byte key: hex() drops leading zeros and can emit
        # odd-length strings bytes.fromhex chokes on
        _write_secret_file(os.path.join(args.output_dir, "key"),
                           f"0x{keypair.priv:064x}")
        print(json.dumps({"enr": enr.to_text(),
                          "node_id": "0x" + keypair.node_id.hex(),
                          "output_dir": args.output_dir}))
        return 0

    if args.lcli_cmd == "mock-el":
        # Reference `lcli mock-el`: a standalone fake execution engine a
        # beacon node can point its --execution-endpoint at for testing.
        import secrets as _secrets

        from .execution_layer.mock_server import MockEngineServer

        if args.jwt_output and args.jwt_secret:
            raise SystemExit("--jwt-output and --jwt-secret are exclusive: "
                             "generate a fresh secret OR reuse an existing one")
        if args.jwt_output:
            secret = _secrets.token_bytes(32)
            # owner-only: the secret authenticates engine-API calls
            _write_secret_file(args.jwt_output, "0x" + secret.hex())
        else:
            raw = _read_password(args.jwt_secret, "jwt secret (hex): ")
            try:
                secret = bytes.fromhex(raw.removeprefix("0x"))
            except ValueError as e:
                raise SystemExit(f"invalid jwt secret hex: {e}")
            if len(secret) != 32:
                raise SystemExit(
                    f"jwt secret must be 32 bytes, got {len(secret)}")
        server = MockEngineServer(secret, port=args.port).start()
        print(json.dumps({"endpoint": server.url,
                          "jwt_secret_file": args.jwt_output or "(provided)"}))
        sys.stdout.flush()
        stop = threading.Event()
        for s in (signal.SIGINT, signal.SIGTERM):
            signal.signal(s, lambda *_: stop.set())
        stop.wait()
        server.stop()
        return 0

    if args.lcli_cmd == "skip-slots":
        spec = _spec_for(args.network)
        types = build_types(spec.preset)
        from .consensus.per_slot import process_slots

        with open(args.pre_state, "rb") as f:
            data = f.read()
        state = types.state[args.fork].from_ssz_bytes(data)
        t0 = time.perf_counter()
        state = process_slots(state, int(state.slot) + args.slots, types, spec)
        dt = time.perf_counter() - t0
        print(json.dumps({"slots": args.slots, "seconds": round(dt, 3),
                          "state_root": "0x" + state.hash_tree_root().hex()}))
        if args.output:
            with open(args.output, "wb") as f:
                f.write(state.as_ssz_bytes())
        return 0

    if args.lcli_cmd in ("state-root", "block-root"):
        spec = _spec_for(args.network)
        types = build_types(spec.preset)
        with open(args.file, "rb") as f:
            data = f.read()
        registry = types.state if args.lcli_cmd == "state-root" else types.signed_block
        obj = registry[args.fork].from_ssz_bytes(data)
        root = (obj.hash_tree_root() if args.lcli_cmd == "state-root"
                else obj.message.hash_tree_root())
        print(json.dumps({"root": "0x" + root.hex()}))
        return 0

    if args.lcli_cmd == "parse-ssz":
        spec = _spec_for(args.network)
        types = build_types(spec.preset)
        from .http_api.serde import to_json

        cls = getattr(types, args.type_name, None)
        if cls is None:
            cls = types.signed_block.get(args.type_name) or types.state.get(args.type_name)
        if cls is None:
            print(f"unknown type {args.type_name!r}", file=sys.stderr)
            return 1
        with open(args.file, "rb") as f:
            obj = cls.from_ssz_bytes(f.read())
        print(json.dumps(to_json(obj), indent=2))
        return 0
    return 1


def _parse_pubkey(s: str) -> bytes:
    raw = s[2:] if s.startswith("0x") else s
    try:
        pk = bytes.fromhex(raw)
    except ValueError:
        raise SystemExit(f"invalid pubkey {s!r}")
    if len(pk) != 48:
        raise SystemExit(f"pubkey must be 48 bytes: {s!r}")
    return pk


def run_validator_manager(args) -> int:
    """``lighthouse validator_manager`` equivalent: manage a RUNNING VC's
    keys over its keymanager API (reference ``validator_manager/``)."""
    from .validator_client.keymanager import KeymanagerClient

    token = args.token
    if args.token_file:
        with open(args.token_file) as f:
            token = f.read().strip()
    if not token:
        raise SystemExit("provide --token or --token-file")
    client = KeymanagerClient(args.vc_url, token)

    if args.vm_cmd == "list":
        for row in client.list_keystores():
            print(row["validating_pubkey"])
        for row in client.list_remotekeys():
            print(f"{row['pubkey']} (remote: {row['url']})")
        return 0
    if args.vm_cmd == "import":
        from .crypto import keystore as ks

        password = _read_password(args.password_file, "keystore password: ")
        keystores = []
        for name in sorted(os.listdir(args.keystores_dir)):
            if name.endswith(".json"):
                keystores.append(ks.load_json(os.path.join(args.keystores_dir, name)))
        if not keystores:
            raise SystemExit(f"no keystores under {args.keystores_dir}")
        protection = None
        if args.slashing_protection:
            with open(args.slashing_protection) as f:
                protection = f.read()
        statuses = client.import_keystores(
            keystores, [password] * len(keystores), protection
        )
        for ks_obj, st in zip(keystores, statuses):
            print(f"0x{ks_obj.get('pubkey', '')[:16]}…: {st['status']}")
        return 0 if all(s["status"] == "imported" for s in statuses) else 1
    if args.vm_cmd == "delete":
        resp = client.delete_keystores([_parse_pubkey(p) for p in args.pubkeys])
        for p, st in zip(args.pubkeys, resp["data"]):
            print(f"{p}: {st['status']}")
        if args.slashing_protection_out:
            with open(args.slashing_protection_out, "w") as f:
                f.write(resp["slashing_protection"])
            print(f"slashing protection exported to {args.slashing_protection_out}")
        return 0
    if args.vm_cmd == "import-remote":
        statuses = client.import_remotekeys(
            [{"pubkey": "0x" + _parse_pubkey(p).hex(), "url": args.signer_url}
             for p in args.pubkeys]
        )
        for p, st in zip(args.pubkeys, statuses):
            print(f"{p}: {st['status']}")
        return 0
    return 1


def run_watch(args) -> int:
    """Chain analytics service (reference ``watch/``): poll a BN, serve
    aggregates."""
    from .http_api import BeaconNodeHttpClient
    from .watch import WatchDB, WatchServer, WatchUpdater

    spec = _spec_for(args.network)
    db = WatchDB(args.db)
    updater = WatchUpdater(
        client=BeaconNodeHttpClient(args.beacon_node), db=db, spec=spec
    )
    server = WatchServer(db, port=args.port).start()
    print(f"watch serving on {server.url}, polling {args.beacon_node}")
    try:
        while True:
            try:
                n = updater.update()
                if n:
                    print(f"ingested {n} slots (highest {db.highest_slot()})")
            except Exception as e:
                print(f"update failed: {e}")
            time.sleep(args.interval)
    except KeyboardInterrupt:
        server.stop()
        db.close()
    return 0


def run_boot_node(args) -> int:
    """Standalone discovery bootstrapper (reference ``boot_node/``)."""
    from .network.boot_node import run_forever

    run_forever(args.listen_address, args.port)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lighthouse-tpu",
        description="Ethereum consensus client on a CUDA card",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    bn = sub.add_parser("beacon_node", aliases=["bn"], help="run a beacon node")
    bn.add_argument("--network", default="mainnet")
    bn.add_argument("--testnet-dir", default=None,
                    help="directory holding a config.yaml network definition")
    bn.add_argument("--monitoring-endpoint", default=None,
                    help="push node stats to this client-stats URL every 60s")
    bn.add_argument("--listen-port", type=int, default=None,
                    help="join the p2p network, listening on this TCP port")
    bn.add_argument("--peers", default=None,
                    help="comma-separated host:port static peers to dial")
    bn.add_argument("--boot-nodes", default=None,
                    help="comma-separated host:port boot nodes for discovery")
    bn.add_argument("--checkpoint-sync-url", default=None,
                    help="boot from this trusted node's finalized checkpoint")
    bn.add_argument("--datadir", default=None)
    bn.add_argument("--http-port", type=int, default=5052)
    bn.add_argument("--execution-endpoint", default=None)
    bn.add_argument("--execution-jwt", default=None)
    bn.add_argument("--interop-validators", type=int, default=None)
    bn.add_argument("--interop-genesis-time", type=int, default=None)
    bn.add_argument("--genesis-state", default=None)
    bn.add_argument("--slasher", action="store_true")
    bn.add_argument("--bls-backend", default="torch", choices=["torch", "host", "fake"])
    bn.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the device routes run: the card, or the CPU "
                         "(the CUDA kernels' plain versions)")
    bn.add_argument("--aot-warmup", action="store_true",
                    help="warm the standard verifier buckets at startup, one "
                         "neutral verify each on a background thread "
                         "(LIGHTHOUSE_TPU_AOT_BUCKETS picks them)")
    bn.add_argument("--debug", action="store_true")
    bn.add_argument("--log-json", action="store_true", dest="log_json",
                    help="emit structured JSON log lines (one object per line)")
    bn.set_defaults(func=run_beacon_node)

    vc = sub.add_parser("validator_client", aliases=["vc"], help="run a validator client")
    vc.add_argument("--network", default="mainnet")
    vc.add_argument("--beacon-nodes", default="http://127.0.0.1:5052")
    vc.add_argument("--keystore-dir", required=True)
    vc.add_argument("--password-file", default=None)
    vc.add_argument("--slashing-protection-db", default=None)
    vc.add_argument("--keymanager-port", type=int, default=None,
                    help="serve the keymanager API on this port")
    vc.set_defaults(func=run_validator_client)

    am = sub.add_parser("account_manager", aliases=["am", "account"],
                        help="wallets, validators, slashing protection")
    am.add_argument("--base-dir", default=os.path.expanduser("~/.lighthouse-tpu"))
    amsub = am.add_subparsers(dest="account_cmd", required=True)
    w = amsub.add_parser("wallet-create")
    w.add_argument("--name", required=True)
    w.add_argument("--password-file", default=None)
    v = amsub.add_parser("validator-create")
    v.add_argument("--wallet", required=True)
    v.add_argument("--count", type=int, default=1)
    v.add_argument("--password-file", default=None)
    v.add_argument("--keystore-password-file", default=None)
    amsub.add_parser("validator-list")
    ex = amsub.add_parser("slashing-protection-export")
    ex.add_argument("--db", required=True)
    ex.add_argument("--out", required=True)
    ex.add_argument("--genesis-validators-root", required=True)
    im = amsub.add_parser("slashing-protection-import")
    im.add_argument("--db", required=True)
    im.add_argument("--interchange", required=True)
    im.add_argument("--genesis-validators-root", required=True)
    am.set_defaults(func=run_account)

    db = sub.add_parser("database_manager", aliases=["db"],
                        help="inspect/compact a node database")
    dbsub = db.add_subparsers(dest="db_cmd", required=True)
    for name in ("version", "inspect", "compact"):
        d = dbsub.add_parser(name)
        d.add_argument("--datadir", required=True)
    # --network is REQUIRED on the destructive commands: decoding a
    # mainnet db with the minimal preset rewrites valid blocks as garbage
    pp = dbsub.add_parser("prune-payloads",
                          help="strip execution payloads from stored blocks")
    pp.add_argument("--datadir", required=True)
    pp.add_argument("--network", required=True)
    pb = dbsub.add_parser("prune-blobs",
                          help="drop blob sidecars below a slot horizon")
    pb.add_argument("--datadir", required=True)
    pb.add_argument("--network", required=True)
    pb.add_argument("--before-slot", type=int, required=True)
    db.set_defaults(func=run_database_manager)

    lcli = sub.add_parser("lcli", help="dev tools (transition timing, roots, ssz)")
    lsub = lcli.add_subparsers(dest="lcli_cmd", required=True)
    tb = lsub.add_parser("transition-bench")
    tb.add_argument("--validators", type=int, default=16384)
    tb.add_argument("--slots", type=int, default=None)
    tb.add_argument("--runs", type=int, default=1)
    sk = lsub.add_parser("skip-slots")
    sk.add_argument("--network", default="minimal")
    sk.add_argument("--fork", default="capella")
    sk.add_argument("--pre-state", required=True)
    sk.add_argument("--slots", type=int, required=True)
    sk.add_argument("--output", default=None)
    for name in ("state-root", "block-root"):
        r = lsub.add_parser(name)
        r.add_argument("--network", default="minimal")
        r.add_argument("--fork", default="capella")
        r.add_argument("file")
    ge = lsub.add_parser("generate-bootnode-enr",
                         help="mint a bootnode key + signed ENR")
    ge.add_argument("--ip", required=True)
    ge.add_argument("--udp-port", type=int, required=True)
    ge.add_argument("--tcp-port", type=int, required=True)
    ge.add_argument("--output-dir", required=True)
    me = lsub.add_parser("mock-el", help="run a standalone fake execution engine")
    me.add_argument("--port", type=int, default=0)
    me.add_argument("--jwt-output", default="",
                    help="write a fresh jwt secret here (hex)")
    me.add_argument("--jwt-secret", default="",
                    help="file holding an existing jwt secret (hex)")
    ps = lsub.add_parser("parse-ssz")
    ps.add_argument("--network", default="minimal")
    ps.add_argument("type_name")
    ps.add_argument("file")
    lcli.set_defaults(func=run_lcli)

    vm = sub.add_parser("validator_manager", aliases=["vm"],
                        help="manage a running VC's keys over the keymanager API")
    vm.add_argument("--vc-url", default="http://127.0.0.1:5062")
    vm.add_argument("--token", default=None)
    vm.add_argument("--token-file", default=None)
    vmsub = vm.add_subparsers(dest="vm_cmd", required=True)
    vmsub.add_parser("list")
    vi = vmsub.add_parser("import")
    vi.add_argument("--keystores-dir", required=True)
    vi.add_argument("--password-file", default=None)
    vi.add_argument("--slashing-protection", default=None)
    vd = vmsub.add_parser("delete")
    vd.add_argument("pubkeys", nargs="+")
    vd.add_argument("--slashing-protection-out", default=None)
    vr = vmsub.add_parser("import-remote")
    vr.add_argument("pubkeys", nargs="+")
    vr.add_argument("--signer-url", required=True)
    vm.set_defaults(func=run_validator_manager)

    watch = sub.add_parser("watch", help="chain analytics: poll a BN, serve aggregates")
    watch.add_argument("--network", default="mainnet")
    watch.add_argument("--beacon-node", default="http://127.0.0.1:5052")
    watch.add_argument("--db", default="watch.sqlite")
    watch.add_argument("--port", type=int, default=5059)
    watch.add_argument("--interval", type=float, default=12.0)
    watch.set_defaults(func=run_watch)

    boot = sub.add_parser("boot_node", help="run a peer-introduction boot node")
    boot.add_argument("--listen-address", default="0.0.0.0")
    boot.add_argument("--port", type=int, default=9100)
    boot.set_defaults(func=run_boot_node)
    return p


def _wait_for_shutdown() -> None:
    stop = {"flag": False}

    def handler(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)
    while not stop["flag"]:
        time.sleep(0.5)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
