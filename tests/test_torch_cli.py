"""The port's command line (``cli.py``, ``__main__.py``,
``transition_bench.py``) vs the JAX package's, and the port's imports.

- The JAX package's ``test_cli_tools.py`` and ``test_keystore_cli.py``
  re-pointed at the port (``lcli`` state and block roots, skip-slots and
  SSZ parsing, the database manager, ``lcli mock-el`` in a second process,
  ``lcli generate-bootnode-enr``, keystores and wallets, the account
  manager, the parser, a builder-assembled node), and
  ``test_keymanager.py::test_validator_manager_cli_roundtrip``;
- both packages' ``lcli`` subcommands print the same JSON on the same files
  (the seconds of ``skip-slots`` aside);
- both parsers have the same subcommands and flags but for ``bn``'s
  ``--device`` (the port's: the card or the CPU) and ``--bls-backend``'s
  device backend (``torch`` for ``jax``); ``--aot-warmup`` is in both;
- ``lcli transition-bench`` runs the port's own bench module;
- no module of the port imports ``jax`` or ``lighthouse_tpu``, and none but
  ``conformance/handler.py`` (the spec-test runner's optional import)
  imports ``yaml``; ``python -m lighthouse_tpu_torch --help`` loads neither.

Chains run on the port's CPU routes (host tree hashing, the numpy epoch
backend) with fake crypto.
"""

import ast
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu import cli as jcli  # noqa: E402
from lighthouse_tpu_torch import cli  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.crypto import keystore as ks  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from test_torch_chain import port_cpu  # noqa: E402,F401
from test_torch_keymanager import _mk_keystore, rig  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "lighthouse_tpu_torch"
PASSWORD = "correct horse battery staple"
SECRET = bytes.fromhex("000000000019d6689c085ae165831e934ff763ae46a2a6c172b3f1b60a8ce26f")
#: The EIP-2335 test password: mathematical-fraktur letters that NFKD-normalize
#: to "testpassword", then the key emoji.
EIP_PASSWORD = "".join(chr(0x1D51E + ord(c) - ord("a")) for c in "testpassword") + "\U0001f511"
#: The flags by which the parsers differ, each for a reason the module
#: docstring gives.
PORT_ONLY = {("beacon_node", "--device")}
JAX_ONLY = set()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def state_file(tmp_path):
    set_backend("fake")
    harness = BeaconChainHarness(validator_count=8, fake_crypto=True)
    path = tmp_path / "state.ssz"
    state = harness.chain.head_state
    path.write_bytes(state.as_ssz_bytes())
    return str(path), state, harness


def jax_json(argv):
    """The JAX package's ``cli.main(argv)`` and its printed JSON."""
    out = io.StringIO()
    with redirect_stdout(out):
        assert jcli.main(argv) == 0
    return json.loads(out.getvalue().strip())


# -------------------------------------- the JAX package's test_cli_tools


def test_lcli_state_root(state_file, capsys):
    path, state, harness = state_file
    fork = type(state).fork_name
    argv = ["lcli", "state-root", "--network", "minimal", "--fork", fork, path]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["root"] == "0x" + state.hash_tree_root().hex()
    assert out == jax_json(argv)


def test_lcli_skip_slots(state_file, tmp_path, capsys):
    path, state, harness = state_file
    fork = type(state).fork_name
    out_path = str(tmp_path / "post.ssz")
    argv = ["lcli", "skip-slots", "--network", "minimal", "--fork", fork,
            "--pre-state", path, "--slots", "2", "--output", out_path]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["slots"] == 2
    from lighthouse_tpu_torch.types.containers import build_types

    types = build_types(harness.spec.preset)
    post = types.state[fork].from_ssz_bytes(open(out_path, "rb").read())
    assert int(post.slot) == int(state.slot) + 2
    assert "0x" + post.hash_tree_root().hex() == out["state_root"]
    ours = open(out_path, "rb").read()
    theirs = jax_json(argv)
    assert {k: v for k, v in out.items() if k != "seconds"} == \
        {k: v for k, v in theirs.items() if k != "seconds"}
    assert open(out_path, "rb").read() == ours


def test_lcli_parse_ssz(state_file, tmp_path, capsys):
    path, state, harness = state_file
    block = harness.produce_signed_block(slot=harness.advance_slot())
    p = tmp_path / "eth1_data.ssz"
    p.write_bytes(block.message.body.eth1_data.as_ssz_bytes())
    argv = ["lcli", "parse-ssz", "--network", "minimal", "Eth1Data", str(p)]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert "deposit_root" in out
    assert out == jax_json(argv)


def test_lcli_block_root_matches_jax(state_file, tmp_path, capsys):
    path, state, harness = state_file
    block = harness.produce_signed_block(slot=harness.advance_slot())
    p = tmp_path / "block.ssz"
    p.write_bytes(block.as_ssz_bytes())
    argv = ["lcli", "block-root", "--network", "minimal",
            "--fork", type(block.message).fork_name, str(p)]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["root"] == "0x" + block.message.hash_tree_root().hex()
    assert out == jax_json(argv)


def test_db_manager_roundtrip(tmp_path, capsys):
    import struct

    from lighthouse_tpu_torch.store.kv import DBColumn
    from lighthouse_tpu_torch.store.lockbox_store import LockboxStore

    datadir = tmp_path / "node"
    datadir.mkdir()
    store = LockboxStore(str(datadir / "chain.db"))
    store.put(DBColumn.BEACON_META, b"schema", struct.pack(">Q", 1))
    store.put(DBColumn.BEACON_BLOCK, b"k" * 32, b"v")
    store.close()

    assert cli.main(["db", "version", "--datadir", str(datadir)]) == 0
    assert json.loads(capsys.readouterr().out.strip())["schema_version"] == 1

    assert cli.main(["db", "inspect", "--datadir", str(datadir)]) == 0
    counts = json.loads(capsys.readouterr().out.strip())["keys_per_column"]
    assert counts.get("BEACON_BLOCK") == 1

    assert cli.main(["db", "compact", "--datadir", str(datadir)]) == 0
    assert json.loads(capsys.readouterr().out.strip())["compacted"] is True


def test_db_prune_payloads_and_blobs(tmp_path, capsys):
    """`db prune-payloads` rewrites stored full blocks as blinded (payload
    reconstructible via the EL); `db prune-blobs` drops sidecars below the
    horizon.  Reference `lighthouse db prune-payloads` / `prune-blobs`."""
    from lighthouse_tpu_torch.store.kv import DBColumn
    from lighthouse_tpu_torch.store.lockbox_store import LockboxStore

    set_backend("fake")
    harness = BeaconChainHarness(validator_count=8, fake_crypto=True)
    harness.extend_chain(2)
    types = harness.chain.types
    datadir = tmp_path / "node"
    datadir.mkdir()
    store = LockboxStore(str(datadir / "chain.db"))
    # both chain blocks in the on-disk db: prune/skip accounting over more
    # than one row
    head = harness.chain.get_block(harness.chain.head_root)
    parent = harness.chain.get_block(bytes(head.message.parent_root))
    for signed in (head, parent):
        fork = type(signed).fork_name
        store.put(DBColumn.BEACON_BLOCK, signed.message.hash_tree_root(),
                  fork.encode() + b"\x00" + signed.as_ssz_bytes())
    store.close()

    assert cli.main(["db", "prune-payloads", "--datadir", str(datadir),
                     "--network", "minimal"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["payloads_pruned"] == 2

    # blinded on disk now; a second run skips them all
    store = LockboxStore(str(datadir / "chain.db"))
    raw = store.get(DBColumn.BEACON_BLOCK, harness.chain.head_root)
    assert raw.startswith(b"blinded:")
    fork = raw.split(b"\x00", 1)[0][len(b"blinded:"):].decode()
    blinded = types.signed_blinded_block[fork].from_ssz_bytes(raw.split(b"\x00", 1)[1])
    assert hasattr(blinded.message.body, "execution_payload_header")
    # a default sidecar (slot 0) sits below any positive horizon
    sc = types.BlobSidecar()
    store.put(DBColumn.BLOB_SIDECAR, b"r" * 32,
              len(sc.as_ssz_bytes()).to_bytes(4, "big") + sc.as_ssz_bytes())
    store.close()
    assert cli.main(["db", "prune-payloads", "--datadir", str(datadir),
                     "--network", "minimal"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["payloads_pruned"] == 0 and out["skipped"] == 2

    assert cli.main(["db", "prune-blobs", "--datadir", str(datadir),
                     "--network", "minimal", "--before-slot", "100"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["blob_sets_pruned"] == 1


def test_lcli_mock_el_serves_engine_api(tmp_path):
    """`lcli mock-el` runs a standalone fake EL a BN can connect to
    (reference `lcli mock-el`), here as `python -m lighthouse_tpu_torch`."""
    from lighthouse_tpu_torch.execution_layer.engine_api import EngineApiClient

    jwt_path = tmp_path / "jwt.hex"
    proc = subprocess.Popen(
        [sys.executable, "-m", "lighthouse_tpu_torch", "lcli", "mock-el",
         "--jwt-output", str(jwt_path)],
        stdout=subprocess.PIPE, cwd=str(REPO),
    )
    try:
        info = json.loads(proc.stdout.readline().decode())
        assert info["endpoint"].startswith("http://127.0.0.1:")
        secret = bytes.fromhex(jwt_path.read_text().removeprefix("0x"))
        assert len(secret) == 32
        # a real engine-API exchange through the spawned process
        caps = EngineApiClient(info["endpoint"], secret).exchange_capabilities()
        assert any("engine_newPayload" in c for c in caps)
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        proc.stdout.close()


def test_lcli_generate_bootnode_enr(tmp_path, capsys):
    """`lcli generate-bootnode-enr` mints a decodable signed ENR + key
    (reference lcli generate_bootnode_enr.rs), on the port's own
    secp256k1."""
    from lighthouse_tpu_torch.network.discv5.enr import ENR

    out_dir = tmp_path / "bootnode"
    argv = ["lcli", "generate-bootnode-enr", "--ip", "10.1.2.3", "--udp-port", "9000",
            "--tcp-port", "9001", "--output-dir", str(out_dir)]
    assert cli.main(argv) == 0
    info = json.loads(capsys.readouterr().out.strip())
    enr = ENR.from_text((out_dir / "enr.dat").read_text())
    assert info["enr"] == enr.to_text() and enr.verify()
    assert enr.ip() == "10.1.2.3" and enr.udp_port() == 9000
    key = (out_dir / "key").read_text()
    assert key.startswith("0x") and int(key, 16) > 0
    # refuses to clobber
    with pytest.raises(SystemExit):
        cli.main(argv)


# ------------------------------------- the JAX package's test_keystore_cli


class TestKeystore:
    def test_roundtrip_scrypt(self):
        keystore = ks.encrypt(SECRET, PASSWORD, kdf="scrypt", _test_fast_kdf=True)
        assert ks.decrypt(keystore, PASSWORD) == SECRET

    def test_roundtrip_pbkdf2(self):
        keystore = ks.encrypt(SECRET, PASSWORD, kdf="pbkdf2", _test_fast_kdf=True)
        assert ks.decrypt(keystore, PASSWORD) == SECRET

    def test_wrong_password_rejected(self):
        keystore = ks.encrypt(SECRET, PASSWORD, _test_fast_kdf=True)
        with pytest.raises(ks.KeystoreError, match="checksum"):
            ks.decrypt(keystore, "wrong")

    @staticmethod
    def vector(kdf: dict, checksum: str, message: str) -> dict:
        return {"crypto": {
            "kdf": kdf,
            "checksum": {"function": "sha256", "params": {}, "message": checksum},
            "cipher": {"function": "aes-128-ctr",
                       "params": {"iv": "264daa3f303d7259501c93d997d84fe6"},
                       "message": message},
        }, "version": 4}

    def test_eip2335_scrypt_vector(self):
        """The EIP-2335 scrypt test vector: decrypting with the spec
        password recovers the spec secret byte for byte."""
        import unicodedata

        vector = self.vector(
            {"function": "scrypt", "message": "", "params": {
                "dklen": 32, "n": 262144, "p": 1, "r": 8,
                "salt": "d4e56740f876aef8c010b86a40d5f56745a118d0906a34e69aec8c0db1cb8fa3"}},
            "d2217fe5f3e9a1e34581ef8a78f7c9928e436d36dacc5e846690a5581e8ea484",
            "06ae90d55fe0a6e9c5c3bc5b170827b2e5cce3929ed3f116c2811e6366dfe20f")
        assert unicodedata.normalize("NFKD", EIP_PASSWORD).startswith("testpassword")
        assert ks.decrypt(vector, EIP_PASSWORD) == SECRET

    def test_eip2335_pbkdf2_vector(self):
        vector = self.vector(
            {"function": "pbkdf2", "message": "", "params": {
                "dklen": 32, "c": 262144, "prf": "hmac-sha256",
                "salt": "d4e56740f876aef8c010b86a40d5f56745a118d0906a34e69aec8c0db1cb8fa3"}},
            "8a9f5d9912ed7e75ea794bc5a89bca5f193721d30868ade6f73043c6ea6febf1",
            "cee03fde2af33149775b7223e7845e4fb2c8ae1792e5f99fe9ecf474cc8c16ad")
        assert ks.decrypt(vector, EIP_PASSWORD) == SECRET


class TestWallet:
    def test_wallet_derives_eip2334_paths(self):
        from lighthouse_tpu_torch.crypto import key_derivation as kd

        wallet, seed = ks.create_wallet("w", PASSWORD, _test_fast_kdf=True)
        derived = ks.derive_validator_keystores(wallet, PASSWORD, "kspass", 2,
                                                _test_fast_kdf=True)
        assert wallet["nextaccount"] == 2
        for i, (keystore, sk_int) in enumerate(derived):
            assert keystore["path"] == f"m/12381/3600/{i}/0/0"
            assert sk_int == kd.derive_path(seed, keystore["path"])
            sk = ks.load_keystore_signing_key(keystore, "kspass")
            assert sk.scalar == sk_int
            assert keystore["pubkey"] == sk.public_key().to_bytes().hex()
        # a third derivation continues from nextaccount
        more = ks.derive_validator_keystores(wallet, PASSWORD, "kspass", 1,
                                             _test_fast_kdf=True)
        assert more[0][0]["path"] == "m/12381/3600/2/0/0"


class TestCli:
    def test_account_wallet_and_validators(self, tmp_path, capsys):
        pw = tmp_path / "pw.txt"
        pw.write_text("hunter2hunter2")
        base = str(tmp_path / "base")
        assert cli.main(["account_manager", "--base-dir", base, "wallet-create",
                         "--name", "test", "--password-file", str(pw)]) == 0
        wallet_path = os.path.join(base, "wallet-test.json")
        assert os.path.exists(wallet_path)
        # rewrite the wallet with fast KDF parameters (same seed)
        wallet = ks.load_json(wallet_path)
        seed = ks.wallet_seed(wallet, "hunter2hunter2")
        fast, _ = ks.create_wallet("test", "hunter2hunter2", seed=seed, _test_fast_kdf=True)
        ks.save_json(fast, wallet_path)
        # validator-create is slow with real scrypt; derive directly instead
        derived = ks.derive_validator_keystores(fast, "hunter2hunter2", "kspass", 1,
                                                _test_fast_kdf=True)
        vdir = os.path.join(base, "validators")
        os.makedirs(vdir, exist_ok=True)
        ks.save_json(derived[0][0], os.path.join(vdir, "keystore-x.json"))
        capsys.readouterr()
        assert cli.main(["account_manager", "--base-dir", base, "validator-list"]) == 0
        assert f"0x{derived[0][0]['pubkey']}" in capsys.readouterr().out

    def test_parser_shape(self):
        p = cli.build_parser()
        args = p.parse_args(["bn", "--network", "minimal", "--interop-validators", "16",
                             "--http-port", "5099", "--bls-backend", "fake"])
        assert args.func.__name__ == "run_beacon_node"
        assert args.device == "cuda" and args.bls_backend == "fake"
        assert p.parse_args(["bn"]).bls_backend == "torch"
        args = p.parse_args(["vc", "--keystore-dir", "/tmp/x"])
        assert args.func.__name__ == "run_validator_client"


class TestClientBuilder:
    def test_build_and_run_minimal_node(self, tmp_path):
        """Full staged assembly on the CPU: datadir-backed store, http API,
        slasher — a real socket node from the builder, then clean
        shutdown."""
        from lighthouse_tpu_torch.client import ClientBuilder
        from lighthouse_tpu_torch.http_api import BeaconNodeHttpClient
        from lighthouse_tpu_torch.types.spec import minimal_spec

        client = (
            ClientBuilder()
            .with_device("cpu")
            .with_spec(minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                                    capella_fork_epoch=0, deneb_fork_epoch=None))
            .with_interop_genesis(16, genesis_time=1_600_000_000)
            .with_datadir(str(tmp_path / "node"))
            .with_http_api(0)
            .with_slasher()
            .with_bls_backend("fake")
            .build()
            .start()
        )
        try:
            api = BeaconNodeHttpClient(client.http_server.url)
            assert api.node_version().startswith("lighthouse-tpu/")
            assert api.genesis()["genesis_time"] == "1600000000"
            assert client.slasher is not None
            assert os.path.exists(str(tmp_path / "node" / "chain.db"))
        finally:
            client.stop()


# ----------------------------------- test_keymanager's held-back CLI case


def test_validator_manager_cli_roundtrip(rig, tmp_path, capsys):  # noqa: F811
    store, server, client = rig
    kdir = tmp_path / "keystores"
    kdir.mkdir()
    keystore = _mk_keystore(2, "pw2")
    (kdir / "keystore-a.json").write_text(json.dumps(keystore))
    (tmp_path / "pw.txt").write_text("pw2")
    (tmp_path / "token.txt").write_text(server.token)

    assert cli.main(["validator_manager", "--vc-url", server.url,
                     "--token-file", str(tmp_path / "token.txt"),
                     "import", "--keystores-dir", str(kdir),
                     "--password-file", str(tmp_path / "pw.txt")]) == 0
    assert store.has_key(bytes.fromhex(keystore["pubkey"]))

    assert cli.main(["vm", "--vc-url", server.url, "--token", server.token, "list"]) == 0
    assert "0x" + keystore["pubkey"] in capsys.readouterr().out


# ------------------------------------------------------ the parsers' shape


def parser_shape(parser, path=()) -> dict:
    """Every flag and positional of every (sub)command: {(command, flag):
    (dest, default, choices, required, nargs, type)}; command aliases under
    {(command, "aliases"): sorted aliases}."""
    import argparse

    out = {}
    name = "/".join(path) or "lighthouse"
    for action in parser._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        if isinstance(action, argparse._SubParsersAction):
            seen = {}
            for alias, sub in action.choices.items():
                seen.setdefault(id(sub), (sub, []))[1].append(alias)
            for sub, aliases in seen.values():
                out[(f"{name}/{aliases[0]}", "aliases")] = sorted(aliases[1:])
                out.update(parser_shape(sub, path + (aliases[0],)))
            continue
        key = action.option_strings[0] if action.option_strings else action.dest
        default = action.default
        if key == "--base-dir":
            default = "<home>/.lighthouse-tpu"
        out[(name, key)] = (action.dest, default,
                            tuple(action.choices) if action.choices else None,
                            action.required, action.nargs,
                            getattr(action.type, "__name__", None))
    return out


def test_parsers_have_the_same_commands_and_flags():
    ours = parser_shape(cli.build_parser())
    theirs = parser_shape(jcli.build_parser())
    assert {k for k in ours if k not in theirs} == PORT_ONLY
    assert {k for k in theirs if k not in ours} == JAX_ONLY
    bls = ("beacon_node", "--bls-backend")
    assert ours[bls] == ("bls_backend", "torch", ("torch", "host", "fake"), False, None, None)
    assert theirs[bls] == ("bls_backend", "jax", ("jax", "host", "fake"), False, None, None)
    assert ours[("beacon_node", "--device")][1:3] == ("cuda", ("cuda", "cpu"))
    differ = [k for k in ours if k in theirs and ours[k] != theirs[k] and k != bls]
    assert differ == []


# ------------------------------------------------------- transition-bench


def test_lcli_transition_bench_runs_the_port(monkeypatch):
    """``lcli transition-bench`` runs ``python -m
    lighthouse_tpu_torch.transition_bench`` (never the JAX package's
    script); that module, here on the CPU, prints the JAX script's
    figures."""
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append((cmd, kw)))
    assert cli.main(["lcli", "transition-bench", "--validators", "64", "--slots", "2",
                     "--runs", "2"]) == 0
    cmd = [sys.executable, "-m", "lighthouse_tpu_torch.transition_bench",
           "--validators", "64", "--slots", "2"]
    assert [c for c, _ in calls] == [cmd, cmd]
    assert calls[0][1]["cwd"] == str(REPO)
    monkeypatch.undo()
    res = subprocess.run(cmd + ["--device", "cpu", "--epoch-backends"], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120, check=True)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["slots"] == 2 and out["validators"] == 64
    assert out["epoch_deltas_match"] is True
    assert {"hash_cold_secs", "hash_one_change_secs", "copy_secs", "process_slots_secs",
            "attestation_apply_secs", "attesters_covered"} <= set(out)


# ------------------------------------------------------------- the imports


def imported_modules(path: Path) -> set:
    """The absolute modules a file imports (relative imports resolved)."""
    package = list(path.relative_to(REPO).parts[:-1])
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - (node.level - 1)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            out.add(mod)
            out.update(f"{mod}.{a.name}" for a in node.names)
    return out


def test_no_module_of_the_port_imports_jax_the_jax_package_or_yaml():
    files = sorted(PACKAGE.rglob("*.py"))
    assert len(files) > 150
    for name in ("client/__init__.py", "cli.py", "__main__.py", "network_config/__init__.py",
                 "monitoring/__init__.py", "watch/__init__.py", "light_client/__init__.py",
                 "transition_bench.py"):
        assert PACKAGE / name in files
    offenders, yaml_users = [], []
    for path in files:
        for mod in imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "lighthouse_tpu"):
                offenders.append((str(path.relative_to(REPO)), mod))
            if top == "yaml":
                yaml_users.append(str(path.relative_to(REPO)))
    assert offenders == []
    assert sorted(set(yaml_users)) == ["lighthouse_tpu_torch/conformance/handler.py"]


def test_cli_help_loads_no_yaml_and_no_jax():
    probe = ("import runpy, sys\n"
             "sys.argv = ['lighthouse_tpu_torch', '--help']\n"
             "try:\n"
             "    runpy.run_module('lighthouse_tpu_torch', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    assert e.code == 0, e.code\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('yaml', 'jax', 'lighthouse_tpu'))\n"
             "print('LOADED', bad)\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=str(REPO), capture_output=True,
                         text=True, timeout=120, check=True)
    assert "beacon_node" in res.stdout
    assert res.stdout.strip().splitlines()[-1] == "LOADED []"
