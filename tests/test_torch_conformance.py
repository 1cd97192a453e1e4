"""The port's ``conformance/`` (the EF-style case walker and runners, the
proto-array scenario interpreter) vs the JAX package's.

- every case under ``tests/vectors/conformance`` (EIP-2335 keystores, the
  EIP-2386 wallet, the staking-deposit-cli deposit data, int_to_bytes and
  the seven scripted proto-array scenarios, the last on the port's fork
  choice) runs through both packages' ``run_case`` with the same verdict
  and detail, and the same count for each runner;
- the port's copies of the JAX package's ``test_conformance.py`` cases: the
  EIP-2333 and interop-keypair constants, the deposit-cli signatures (on
  the host and through the port's device program on the CPU's plain
  versions), ``apply_deposit`` on real signatures, the walker on a
  synthetic tree, snappy payloads, and the mainnet trusted setup.

BLS batches run through the ``"torch"`` backend on the CPU.
"""

import json
import os

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu.conformance import handler as jhandler  # noqa: E402
from lighthouse_tpu.crypto.bls import backends as jbackends  # noqa: E402
from lighthouse_tpu_torch.conformance.handler import Case, discover_cases, run_case  # noqa: E402
from lighthouse_tpu_torch.crypto import key_derivation as kd  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as bls  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import backends as pbackends  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend, torch_backend  # noqa: E402

VECTORS = os.path.join(os.path.dirname(__file__), "vectors")
CONFORMANCE = os.path.join(VECTORS, "conformance")


def _load(name):
    with open(os.path.join(VECTORS, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def torch_backend_on_cpu():
    """The ``"torch"`` BLS backend on the CPU's plain versions; the JAX
    package's backend and the port's card defaults come back after."""
    j_prev = jbackends.backend_name()
    set_backend("torch")
    torch_backend.configure(device="cpu")
    yield
    jbackends.set_backend(j_prev)
    pbackends._ACTIVE = pbackends._NAME = None
    torch_backend.reset_for_tests()


# -------------------------------------------------- both packages' verdicts


def test_vector_tree_same_verdicts_as_jax():
    """Every vendored case: the port's verdict and detail are the JAX
    package's, case by case, and every case passes."""
    mine = [(c.runner, c.handler, c.suite, c.name, *run_case(c))
            for c in discover_cases(CONFORMANCE)]
    theirs = [(c.runner, c.handler, c.suite, c.name, *jhandler.run_case(c))
              for c in jhandler.discover_cases(CONFORMANCE)]
    assert mine == theirs
    assert all(ok for *_, ok, _ in mine), [m for m in mine if not m[4]]
    by_runner = {}
    for runner, *_ in mine:
        by_runner[runner] = by_runner.get(runner, 0) + 1
    assert by_runner == {"deposit_data": 12, "fork_choice": 7, "int_to_bytes": 1,
                         "keystore": 2, "wallet": 1}


@pytest.mark.parametrize("runner", ["deposit_data", "fork_choice", "int_to_bytes",
                                    "keystore", "wallet"])
def test_discover_by_runner_matches_jax(runner):
    mine = [c.path for c in discover_cases(CONFORMANCE, runner=runner)]
    assert mine == [c.path for c in jhandler.discover_cases(CONFORMANCE, runner=runner)]
    assert mine


def test_proto_array_scenarios_on_port_fork_choice():
    """The scripted fork-choice scenarios run on the port's proto array."""
    from lighthouse_tpu_torch.conformance import proto_array_runner

    cases = list(discover_cases(CONFORMANCE, runner="fork_choice"))
    assert proto_array_runner.__name__.startswith("lighthouse_tpu_torch.")
    for case in cases:
        ok, detail = run_case(case)
        assert ok, f"{case}: {detail}"


# ------------------------------------------- the JAX package's test cases


def test_eip2333_derivation_vectors():
    for case in _load("eip2333.json")["cases"]:
        master = kd.derive_master_sk(bytes.fromhex(case["seed"]))
        assert master == int(case["master_sk"]), "master sk mismatch"
        child = kd.derive_child_sk(master, int(case["child_index"]))
        assert child == int(case["child_sk"]), "child sk mismatch"


def test_derive_path_matches_manual_chain():
    seed = bytes.fromhex(_load("eip2333.json")["cases"][0]["seed"])
    manual = kd.derive_child_sk(kd.derive_child_sk(kd.derive_master_sk(seed), 12381), 3600)
    assert kd.derive_path(seed, "m/12381/3600") == manual


def test_interop_keypairs_match_external_constants():
    from lighthouse_tpu_torch.consensus.genesis import interop_secret_key

    for i, pair in enumerate(_load("interop_keypairs.json")["pairs"]):
        sk = interop_secret_key(i)
        assert sk.scalar == int.from_bytes(bytes.fromhex(pair["privkey"][2:]), "big")
        assert sk.public_key().to_bytes().hex() == pair["pubkey"][2:]


def _deposit_sets(count):
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.types.containers import build_types
    from lighthouse_tpu_torch.types.spec import DOMAIN_DEPOSIT, mainnet_spec

    types = build_types(mainnet_spec().preset)
    out = []
    for case in _load("deposit_data.json")["cases"][:count]:
        msg = types.DepositMessage(
            pubkey=bytes.fromhex(case["pubkey"]),
            withdrawal_credentials=bytes.fromhex(case["withdrawal_credentials"]),
            amount=case["amount"],
        )
        data = types.DepositData(
            pubkey=bytes.fromhex(case["pubkey"]),
            withdrawal_credentials=bytes.fromhex(case["withdrawal_credentials"]),
            amount=case["amount"],
            signature=bytes.fromhex(case["signature"]),
        )
        domain = h.compute_domain(DOMAIN_DEPOSIT, bytes.fromhex(case["fork_version"]),
                                  b"\x00" * 32)
        root = h.compute_signing_root(msg.hash_tree_root(), domain)
        out.append((case, msg, data, root))
    return out


def test_deposit_data_external_kats():
    for case, msg, data, root in _deposit_sets(None):
        assert msg.hash_tree_root().hex() == case["deposit_message_root"]
        assert data.hash_tree_root().hex() == case["deposit_data_root"]
        pk = bls.PublicKey.from_bytes(bytes.fromhex(case["pubkey"]))
        sig = bls.Signature.from_bytes(bytes.fromhex(case["signature"]))
        assert sig.verify(pk, root), "external deposit signature must verify"


def test_deposit_signatures_verify_on_device_path():
    """The deposit-cli signatures through the port's device program (the
    CUDA kernels' plain versions here); a changed message is refused."""
    from lighthouse_tpu_torch.ops.verify import verify_signature_sets_device

    sets = [bls.SignatureSet(bls.Signature.from_bytes(bytes.fromhex(case["signature"])),
                             root, [bls.PublicKey.from_bytes(bytes.fromhex(case["pubkey"]))])
            for case, _, _, root in _deposit_sets(4)]
    assert verify_signature_sets_device(sets, seed=b"\x07" * 32, device="cpu") is True
    bad = [bls.SignatureSet(s.signature, s.message, s.signing_keys) for s in sets]
    bad[0].message = bytes(32)
    assert verify_signature_sets_device(bad, seed=b"\x07" * 32, device="cpu") is False


def test_apply_deposit_verifies_real_signatures():
    """A correctly signed new-validator deposit is applied; one under
    another key's signature is skipped."""
    from lighthouse_tpu_torch.chain import BeaconChainHarness
    from lighthouse_tpu_torch.consensus import signature_sets as sets
    from lighthouse_tpu_torch.consensus.per_block import apply_deposit
    from lighthouse_tpu_torch.ops import tree_hash as th

    th.configure(enabled=False)
    try:
        set_backend("host")
        harness = BeaconChainHarness(validator_count=8, fake_crypto=False)
        state = harness.chain.head_state.copy()
        spec, types = harness.spec, harness.types
        sk = bls.SecretKey(987654321)
        wc = b"\x01" + b"\x00" * 11 + bytes(range(20))
        amount = 32 * 10**9
        dd = types.DepositData(pubkey=sk.public_key().to_bytes(), withdrawal_credentials=wc,
                               amount=amount, signature=b"\x00" * 96)
        dd.signature = sk.sign(sets.deposit_signature_message(dd, types, spec)).to_bytes()
        n_before = len(state.validators)
        state.eth1_data.deposit_count = state.eth1_deposit_index + 1
        apply_deposit(state, types.Deposit(proof=[b"\x00" * 32] * 33, data=dd), types, spec,
                      verify_proof=False)
        assert len(state.validators) == n_before + 1
        assert bytes(state.validators[-1].pubkey) == sk.public_key().to_bytes()
        dd2 = types.DepositData(pubkey=bls.SecretKey(13579).public_key().to_bytes(),
                                withdrawal_credentials=wc, amount=amount,
                                signature=dd.signature)
        state.eth1_data.deposit_count = state.eth1_deposit_index + 1
        apply_deposit(state, types.Deposit(proof=[b"\x00" * 32] * 33, data=dd2), types, spec,
                      verify_proof=False)
        assert len(state.validators) == n_before + 1, "invalid deposit must be skipped"
    finally:
        th.reset_for_tests()


@pytest.fixture()
def synthetic_ef_tree(tmp_path):
    """A miniature consensus-spec-tests layout for the walker and the bls
    sign and verify runners."""
    import yaml

    sk_hex = "263dbd792f5b1be47ed85f8938c0f29586af0d3ac7b977f21c278fe1462040e3"
    msg = "0x" + "ab" * 32
    sk = bls.SecretKey(int(sk_hex, 16))
    sig = sk.sign(bytes.fromhex(msg[2:]))
    base = tmp_path / "tests" / "general" / "phase0" / "bls"

    def write(handler, name, body):
        d = base / handler / "small" / name
        d.mkdir(parents=True)
        (d / "data.yaml").write_text(yaml.safe_dump(body))

    write("sign", "sign_case_0", {"input": {"privkey": "0x" + sk_hex, "message": msg},
                                  "output": "0x" + sig.to_bytes().hex()})
    verify_in = {"pubkey": sk.public_key().to_bytes().hex(), "message": msg,
                 "signature": "0x" + sig.to_bytes().hex()}
    write("verify", "verify_case_0", {"input": verify_in, "output": True})
    bad = bytearray(sig.to_bytes())
    bad[5] ^= 0x01
    write("verify", "verify_tampered",
          {"input": {**verify_in, "signature": "0x" + bytes(bad).hex()}, "output": False})
    write("batch_verify", "batch_case_0", {
        "input": {"pubkeys": [verify_in["pubkey"]], "messages": [msg],
                  "signatures": [verify_in["signature"]]},
        "output": True})
    return str(tmp_path)


def test_handler_walks_and_runs_cases(synthetic_ef_tree):
    cases = list(discover_cases(synthetic_ef_tree, runner="bls"))
    assert len(cases) == 4
    for case in cases:
        ok, detail = run_case(case)
        assert ok, f"{case}: {detail}"
    theirs = [jhandler.run_case(c)
              for c in jhandler.discover_cases(synthetic_ef_tree, runner="bls")]
    assert [run_case(c) for c in cases] == theirs


def test_handler_ssz_snappy_roundtrip(tmp_path):
    from lighthouse_tpu_torch.network import snappy_codec

    d = tmp_path / "case"
    d.mkdir()
    payload = b"\x01\x02\x03\x04" * 10
    (d / "serialized.ssz_snappy").write_bytes(snappy_codec.compress(payload))
    case = Case(str(d), "general", "phase0", "ssz_static", "X", "small")
    assert case.load_ssz("serialized") == payload


class TestMainnetTrustedSetup:
    """The EF KZG ceremony output: sampled G1 and G2 points decompress and
    pass the subgroup checks; a sparse blob commits, proves and verifies on
    the host golden model, and a changed blob is refused."""

    @pytest.fixture(scope="class")
    def setup_json(self):
        with open(os.path.join(VECTORS, "mainnet_trusted_setup.json")) as f:
            return f.read()

    def test_sampled_points_decompress_and_subgroup_check(self, setup_json):
        from lighthouse_tpu_torch.crypto.bls import curve, serde
        from lighthouse_tpu_torch.crypto.kzg.kzg import _bytes_to_g1

        obj = json.loads(setup_json)
        g1s = obj["g1_lagrange"]
        assert len(g1s) == 4096
        for i in range(0, 4096, 256):
            assert _bytes_to_g1(bytes.fromhex(g1s[i][2:])) is not None
        g2s = obj["g2_monomial"]
        assert len(g2s) == 65
        for s in g2s[:8]:
            assert curve.in_g2(serde.g2_decompress(bytes.fromhex(s[2:])))

    def test_kzg_round_trip_under_real_setup(self, setup_json):
        from lighthouse_tpu_torch.crypto.kzg.kzg import Kzg, TrustedSetup

        setup = TrustedSetup.from_json(setup_json, validate=False)
        kzg = Kzg(setup, device=None)
        blob = b"".join((i + 1).to_bytes(32, "big") if i < 3 else b"\x00" * 32
                        for i in range(setup.width))
        commitment = kzg.blob_to_kzg_commitment(blob)
        proof = kzg.compute_blob_kzg_proof(blob, commitment)
        assert kzg.verify_blob_kzg_proof(blob, commitment, proof)
        assert not kzg.verify_blob_kzg_proof(b"\x00" * 32 + blob[32:], commitment, proof)


def test_reference_vector_tree_green():
    root = CONFORMANCE
    by_runner = {}
    for case in discover_cases(root):
        ok, detail = run_case(case)
        assert ok, f"{case}: {detail}"
        by_runner[case.runner] = by_runner.get(case.runner, 0) + 1
    assert by_runner.get("keystore", 0) >= 2, by_runner
    assert by_runner.get("wallet", 0) >= 1, by_runner
    assert by_runner.get("deposit_data", 0) >= 12, by_runner
    assert by_runner.get("int_to_bytes", 0) >= 1, by_runner
    assert by_runner.get("fork_choice", 0) >= 7, by_runner
