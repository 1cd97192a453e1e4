"""Generic EF spec-test handler: directory walker + typed case runners.

Mirrors the reference's ``testing/ef_tests/src/handler.rs:10-70`` design: a
``Handler`` is (runner name, case fn); cases are the leaf directories of
``tests/<config>/<fork>/<runner>/<handler>/<suite>/<case>``.  The BLS cases
exercise ``verify_signature_sets`` semantics directly
(``testing/ef_tests/src/cases/bls_batch_verify.rs:25-67``) — the bit-identical
gate for the TPU kernel.

Only stdlib + yaml; snappy-compressed ``.ssz_snappy`` payloads are decoded
with our own codec (network/snappy_codec.py).

A copy of the JAX package's ``lighthouse_tpu/conformance/handler.py``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

try:
    import yaml
except ImportError:  # pragma: no cover
    yaml = None


class Case:
    """One leaf case directory."""

    def __init__(self, path: str, config: str, fork: str, runner: str, handler: str, suite: str):
        self.path = path
        self.config = config
        self.fork = fork
        self.runner = runner
        self.handler = handler
        self.suite = suite
        self.name = os.path.basename(path)

    def __repr__(self):
        return f"Case({self.config}/{self.fork}/{self.runner}/{self.handler}/{self.suite}/{self.name})"

    # -- file loading ------------------------------------------------------
    def load_yaml(self, name: str):
        p = os.path.join(self.path, name)
        if not os.path.exists(p):
            return None
        if yaml is None:
            raise RuntimeError("PyYAML is required to load spec-test yaml cases")
        with open(p) as f:
            return yaml.safe_load(f)

    def load_json(self, name: str):
        import json

        p = os.path.join(self.path, name)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def load_ssz(self, name: str) -> Optional[bytes]:
        """Load a .ssz_snappy (preferred) or raw .ssz file."""
        p = os.path.join(self.path, name + ".ssz_snappy")
        if os.path.exists(p):
            from ..network import snappy_codec

            with open(p, "rb") as f:
                return snappy_codec.decompress(f.read())
        p = os.path.join(self.path, name + ".ssz")
        if os.path.exists(p):
            with open(p, "rb") as f:
                return f.read()
        return None


def discover_cases(
    root: str,
    runner: Optional[str] = None,
    config: Optional[str] = None,
    fork: Optional[str] = None,
) -> Iterator[Case]:
    """Walk tests/<config>/<fork>/<runner>/<handler>/<suite>/<case>."""
    tests_root = os.path.join(root, "tests") if os.path.isdir(os.path.join(root, "tests")) else root
    if not os.path.isdir(tests_root):
        return
    for cfg in sorted(os.listdir(tests_root)):
        if config and cfg != config:
            continue
        cfg_dir = os.path.join(tests_root, cfg)
        if not os.path.isdir(cfg_dir):
            continue
        for fk in sorted(os.listdir(cfg_dir)):
            if fork and fk != fork:
                continue
            fk_dir = os.path.join(cfg_dir, fk)
            if not os.path.isdir(fk_dir):
                continue
            for rn in sorted(os.listdir(fk_dir)):
                if runner and rn != runner:
                    continue
                rn_dir = os.path.join(fk_dir, rn)
                if not os.path.isdir(rn_dir):
                    continue
                for hd in sorted(os.listdir(rn_dir)):
                    hd_dir = os.path.join(rn_dir, hd)
                    if not os.path.isdir(hd_dir):
                        continue
                    for suite in sorted(os.listdir(hd_dir)):
                        suite_dir = os.path.join(hd_dir, suite)
                        if not os.path.isdir(suite_dir):
                            continue
                        for case in sorted(os.listdir(suite_dir)):
                            case_dir = os.path.join(suite_dir, case)
                            if os.path.isdir(case_dir):
                                yield Case(case_dir, cfg, fk, rn, hd, suite)


# --------------------------------------------------------------- case runners


def _hex_bytes(s) -> bytes:
    if s is None:
        return b""
    if isinstance(s, bytes):
        return s
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def run_bls_case(case: Case) -> Tuple[bool, str]:
    """Run one bls/<handler> case. Returns (passed, detail)."""
    from ..crypto.bls import api

    data = case.load_yaml("data.yaml")
    if data is None:
        return False, "missing data.yaml"
    inp, expected = data.get("input"), data.get("output")
    h = case.handler
    try:
        if h == "sign":
            sk = api.SecretKey(int.from_bytes(_hex_bytes(inp["privkey"]), "big"))
            got = "0x" + sk.sign(_hex_bytes(inp["message"])).to_bytes().hex()
            return got == expected, f"{got} != {expected}"
        if h == "verify":
            pk = api.PublicKey.from_bytes(_hex_bytes(inp["pubkey"]))
            sig = api.Signature.from_bytes(_hex_bytes(inp["signature"]))
            got = sig.verify(pk, _hex_bytes(inp["message"]))
            return got == expected, f"{got} != {expected}"
        if h == "aggregate":
            sigs = [api.Signature.from_bytes(_hex_bytes(s)) for s in inp]
            if not sigs:
                return (expected is None), "empty aggregate"
            agg = api.AggregateSignature.infinity()
            for s in sigs:
                agg.add_assign(s)
            got = "0x" + agg.to_bytes().hex()
            return got == expected, f"{got} != {expected}"
        if h == "aggregate_verify":
            pks = [api.PublicKey.from_bytes(_hex_bytes(p)) for p in inp["pubkeys"]]
            msgs = [_hex_bytes(m) for m in inp["messages"]]
            sig = api.Signature.from_bytes(_hex_bytes(inp["signature"]))
            got = api.aggregate_verify(pks, msgs, sig)
            return got == expected, f"{got} != {expected}"
        if h == "fast_aggregate_verify":
            pks = [api.PublicKey.from_bytes(_hex_bytes(p)) for p in inp["pubkeys"]]
            sig = api.Signature.from_bytes(_hex_bytes(inp["signature"]))
            got = api.fast_aggregate_verify(pks, _hex_bytes(inp["message"]), sig)
            return got == expected, f"{got} != {expected}"
        if h == "batch_verify":
            # The direct gate on verify_signature_sets
            # (testing/ef_tests/src/cases/bls_batch_verify.rs:25-67).
            pks = [api.PublicKey.from_bytes(_hex_bytes(p)) for p in inp["pubkeys"]]
            msgs = [_hex_bytes(m) for m in inp["messages"]]
            sigs = [api.Signature.from_bytes(_hex_bytes(s)) for s in inp["signatures"]]
            sets = [
                api.SignatureSet.single_pubkey(sig, pk, msg)
                for sig, pk, msg in zip(sigs, pks, msgs)
            ]
            got = api.verify_signature_sets(sets)
            return got == expected, f"{got} != {expected}"
    except Exception as e:
        # Invalid-input cases expect output null/false.
        if expected in (None, False):
            return True, f"rejected: {e}"
        return False, f"exception: {e}"
    return False, f"unknown bls handler {h}"


def run_ssz_static_case(case: Case, types_mod) -> Tuple[bool, str]:
    """ssz_static: round-trip serialized.ssz + check roots.yaml."""
    roots = case.load_yaml("roots.yaml")
    raw = case.load_ssz("serialized")
    if roots is None or raw is None:
        return False, "missing files"
    cls = getattr(types_mod, case.handler, None)
    if cls is None:
        return True, f"skip: no container {case.handler}"
    try:
        value = cls.from_ssz_bytes(raw)
    except Exception as e:
        return False, f"deserialize failed: {e}"
    if value.as_ssz_bytes() != raw:
        return False, "re-serialization mismatch"
    got = "0x" + value.hash_tree_root().hex()
    return got == roots["root"], f"root {got} != {roots['root']}"


def run_keystore_case(case: Case) -> Tuple[bool, str]:
    """EIP-2335 keystore decrypt KAT (reference
    ``crypto/eth2_keystore/tests/eip2335_vectors.rs``)."""
    from ..crypto import keystore as ks

    vector = case.load_json("keystore.json")
    meta = case.load_json("meta.json")
    if vector is None or meta is None:
        return False, "missing keystore.json/meta.json"
    try:
        secret = ks.decrypt(vector, meta["password"])
    except Exception as e:
        return False, f"decrypt failed: {e}"
    if secret.hex() != meta["secret"]:
        return False, f"secret {secret.hex()} != {meta['secret']}"
    if vector.get("path", "") != meta.get("path", ""):
        return False, "path mismatch"
    # the embedded pubkey must match the decrypted secret key
    from ..crypto.bls import api

    pk = api.SecretKey(int.from_bytes(secret, "big")).public_key()
    if pk.to_bytes().hex() != vector["pubkey"]:
        return False, "pubkey does not match decrypted secret"
    try:
        ks.decrypt(vector, meta["password"] + "x")
        return False, "wrong password accepted"
    except Exception:
        pass
    return True, "ok"


def run_wallet_case(case: Case) -> Tuple[bool, str]:
    """EIP-2386 wallet seed-decrypt KAT (reference
    ``crypto/eth2_wallet/tests/eip2386_vectors.rs``)."""
    from ..crypto import keystore as ks

    vector = case.load_json("wallet.json")
    meta = case.load_json("meta.json")
    if vector is None or meta is None:
        return False, "missing wallet.json/meta.json"
    try:
        seed = ks.wallet_seed(vector, meta["password"])
    except Exception as e:
        return False, f"seed decrypt failed: {e}"
    if seed.hex() != meta["seed"]:
        return False, f"seed {seed.hex()} != {meta['seed']}"
    for field in ("name", "nextaccount", "type", "uuid"):
        if vector.get(field) != meta[field]:
            return False, f"{field} mismatch"
    return True, "ok"


def run_deposit_data_case(case: Case) -> Tuple[bool, str]:
    """staking-deposit-cli cross-implementation KAT: re-derive the validator
    keys from the documented mnemonic (EIP-2334 paths), rebuild withdrawal
    credentials, deposit roots and the BLS deposit signature, and demand
    bit-identical output (reference ``validator_manager/test_vectors``)."""
    from ..consensus import helpers as h
    from ..crypto import key_derivation as kd
    from ..crypto.bls import api
    from ..types.containers import build_types
    from ..types.spec import DOMAIN_DEPOSIT, mainnet_spec

    deposits = case.load_json("deposit_data.json")
    meta = case.load_json("meta.json")
    if deposits is None or meta is None:
        return False, "missing deposit_data.json/meta.json"
    if len(deposits) != meta["count"]:
        return False, f"expected {meta['count']} deposits, file has {len(deposits)}"

    types = build_types(mainnet_spec().preset)
    seed = kd.mnemonic_to_seed(meta["mnemonic"])
    for j, entry in enumerate(deposits):
        idx = meta["first_index"] + j
        sk = api.SecretKey(kd.derive_path(seed, f"m/12381/3600/{idx}/0/0"))
        if sk.public_key().to_bytes().hex() != entry["pubkey"]:
            return False, f"deposit {j}: derived pubkey mismatch"
        if meta["eth1_withdrawal"]:
            creds = bytes.fromhex(entry["withdrawal_credentials"])
            if creds[:1] != b"\x01" or creds[1:12] != b"\x00" * 11:
                return False, f"deposit {j}: malformed eth1 credentials"
        else:
            import hashlib

            wd_pk = api.SecretKey(
                kd.derive_path(seed, f"m/12381/3600/{idx}/0")
            ).public_key()
            creds = b"\x00" + hashlib.sha256(wd_pk.to_bytes()).digest()[1:]
            if creds.hex() != entry["withdrawal_credentials"]:
                return False, f"deposit {j}: BLS credentials mismatch"
        msg = types.DepositMessage(
            pubkey=bytes.fromhex(entry["pubkey"]),
            withdrawal_credentials=creds,
            amount=int(entry["amount"]),
        )
        if msg.hash_tree_root().hex() != entry["deposit_message_root"]:
            return False, f"deposit {j}: message root mismatch"
        domain = h.compute_domain(
            DOMAIN_DEPOSIT, bytes.fromhex(entry["fork_version"]), b"\x00" * 32
        )
        sig = sk.sign(h.compute_signing_root(msg.hash_tree_root(), domain))
        if sig.to_bytes().hex() != entry["signature"]:
            return False, f"deposit {j}: signature not bit-identical"
        data = types.DepositData(
            pubkey=bytes.fromhex(entry["pubkey"]),
            withdrawal_credentials=creds,
            amount=int(entry["amount"]),
            signature=sig.to_bytes(),
        )
        if data.hash_tree_root().hex() != entry["deposit_data_root"]:
            return False, f"deposit {j}: data root mismatch"
    return True, f"{len(deposits)} deposits bit-identical"


def run_int_to_bytes_case(case: Case) -> Tuple[bool, str]:
    """Spec ``int_to_bytes[n]`` vectors (reference
    ``consensus/int_to_bytes/src/specs/test_vector_int_to_bytes.yml``) —
    little-endian, per int_to_bytes.rs ``to_le_bytes``."""
    data = case.load_yaml("data.yaml")
    if data is None:
        return False, "missing data.yaml"
    n = 0
    for tc in data["test_cases"]:
        got = int(tc["int"]).to_bytes(int(tc["byte_length"]), "little")
        want = _hex_bytes(tc["bytes"])
        if got != want:
            return False, f"int_to_bytes({tc['int']}, {tc['byte_length']}): " \
                          f"{got.hex()} != {want.hex()}"
        n += 1
    return True, f"{n} cases ok"


def run_proto_array_case(case: Case) -> Tuple[bool, str]:
    """Scripted proto-array fork-choice scenario (ported from the reference's
    ``fork_choice_test_definition`` suite by
    ``scripts/port_proto_array_vectors.py``)."""
    from .proto_array_runner import run_scenario

    scenario = case.load_json("scenario.json")
    if scenario is None:
        return False, "missing scenario.json"
    try:
        n = run_scenario(scenario)
    except Exception as e:
        return False, f"{type(e).__name__}: {e}"
    return True, f"{n} ops ok"


def run_case(case: Case, types_mod=None) -> Tuple[bool, str]:
    if case.runner == "bls":
        return run_bls_case(case)
    if case.runner == "ssz_static" and types_mod is not None:
        return run_ssz_static_case(case, types_mod)
    if case.runner == "keystore":
        return run_keystore_case(case)
    if case.runner == "wallet":
        return run_wallet_case(case)
    if case.runner == "deposit_data":
        return run_deposit_data_case(case)
    if case.runner == "int_to_bytes":
        return run_int_to_bytes_case(case)
    if case.runner == "fork_choice":
        return run_proto_array_case(case)
    return True, f"skip: runner {case.runner} not wired"


def run_all(root: str, runner: Optional[str] = None, types_mod=None) -> Dict[str, List[str]]:
    """Run every discovered case; returns {'passed': [...], 'failed': [...]}."""
    out: Dict[str, List[str]] = {"passed": [], "failed": []}
    for case in discover_cases(root, runner=runner):
        ok, detail = run_case(case, types_mod=types_mod)
        (out["passed"] if ok else out["failed"]).append(f"{case!r}: {detail}")
    return out
