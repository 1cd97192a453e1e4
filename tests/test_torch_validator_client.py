"""The port's validator client (``validator_client/``: the client, its
services, the validator store, EIP-3076 slashing protection, the graffiti
file, Web3Signer) vs the JAX package's.

- The JAX package's ``test_validator_client.py`` re-pointed at the port: a
  harness chain served over real TCP by the port's ``HttpApiServer`` and
  driven only by the port's ``ValidatorClient`` (fake crypto, 16
  validators; one slot with real BLS on the ``"host"`` backend);
- parity: a JAX harness driven by the JAX package's client and a port
  harness driven by the port's, both fake-crypto with 16 validators, for
  one epoch: the same block roots slot by slot, the same attestation bytes
  and the same EIP-3076 interchange JSON;
- the Web3Signer cases of the JAX package's ``test_fault_injection.py``
  (``signer.request``, ``web3signer_retries_total``), and a remote key
  signing byte for byte as the local one on the real-crypto slot.

Chains run on the port's CPU routes (host tree hashing, the numpy epoch
backend).
"""

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu.crypto.bls import backends as jbackends  # noqa: E402
from lighthouse_tpu_torch import fault_injection as fi  # noqa: E402
from lighthouse_tpu_torch import metrics  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.consensus import helpers as h  # noqa: E402
from lighthouse_tpu_torch.consensus import per_epoch as pe  # noqa: E402
from lighthouse_tpu_torch.consensus.genesis import interop_secret_key  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import backends as pbackends  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend, torch_backend  # noqa: E402
from lighthouse_tpu_torch.http_api import BeaconNodeHttpClient, HttpApiServer  # noqa: E402
from lighthouse_tpu_torch.ops import tree_hash as th  # noqa: E402
from lighthouse_tpu_torch.validator_client import (  # noqa: E402
    NoViableBeaconNode,
    SlashingProtectionDB,
    SlashingProtectionError,
    ValidatorClient,
)
from test_torch_chain import harnesses  # noqa: E402

PK_A = b"\xaa" * 48
PK_B = b"\xbb" * 48
ROOT_1 = b"\x11" * 32
ROOT_2 = b"\x22" * 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
def port_cpu_module():
    """The port's CPU routes for the whole module (the served chain lives
    across tests): host tree hashing, the numpy epoch backend, the
    ``"torch"`` BLS backend on the CPU; the JAX package's backend and the
    port's card defaults come back afterwards."""
    j_prev = jbackends.backend_name()
    th.configure(enabled=False)
    pe.configure(backend="numpy")
    torch_backend.configure(device="cpu")
    yield
    jbackends.set_backend(j_prev)
    pbackends._ACTIVE = pbackends._NAME = None
    torch_backend.reset_for_tests()
    pe.reset_for_tests()
    th.reset_for_tests()


@pytest.fixture(autouse=True)
def _clean_faults():
    fi.reset_for_tests()
    yield
    fi.reset_for_tests()


def _client(harness, server, keys, **kw):
    return ValidatorClient(
        keys=keys, beacon_nodes=[BeaconNodeHttpClient(server.url)], spec=harness.spec,
        types=harness.types, genesis_validators_root=harness.chain.genesis_validators_root,
        **kw)


# ------------------------------------------------------ slashing DB unit


class TestSlashingProtectionDB:
    def test_block_double_propose_refused(self):
        db = SlashingProtectionDB()
        db.check_and_insert_block_proposal(PK_A, 10, ROOT_1)
        with pytest.raises(SlashingProtectionError):
            db.check_and_insert_block_proposal(PK_A, 10, ROOT_2)
        db.check_and_insert_block_proposal(PK_A, 10, ROOT_1)  # idempotent
        with pytest.raises(SlashingProtectionError):
            db.check_and_insert_block_proposal(PK_A, 9, ROOT_2)
        db.check_and_insert_block_proposal(PK_A, 11, ROOT_2)
        db.check_and_insert_block_proposal(PK_B, 10, ROOT_1)

    def test_attestation_double_vote_refused(self):
        db = SlashingProtectionDB()
        db.check_and_insert_attestation(PK_A, 2, 3, ROOT_1)
        with pytest.raises(SlashingProtectionError):
            db.check_and_insert_attestation(PK_A, 2, 3, ROOT_2)
        db.check_and_insert_attestation(PK_A, 2, 3, ROOT_1)

    def test_attestation_surround_refused(self):
        db = SlashingProtectionDB()
        db.check_and_insert_attestation(PK_A, 3, 4, ROOT_1)
        with pytest.raises(SlashingProtectionError):
            db.check_and_insert_attestation(PK_A, 2, 5, ROOT_2)
        db2 = SlashingProtectionDB()
        db2.check_and_insert_attestation(PK_A, 2, 5, ROOT_1)
        with pytest.raises(SlashingProtectionError):
            db2.check_and_insert_attestation(PK_A, 3, 4, ROOT_2)

    def test_attestation_monotonic_bounds(self):
        db = SlashingProtectionDB()
        db.check_and_insert_attestation(PK_A, 4, 5, ROOT_1)
        with pytest.raises(SlashingProtectionError):
            db.check_and_insert_attestation(PK_A, 3, 6, ROOT_2)
        with pytest.raises(SlashingProtectionError):
            db.check_and_insert_attestation(PK_A, 4, 5, ROOT_2)
        db.check_and_insert_attestation(PK_A, 4, 6, ROOT_2)

    def test_interchange_roundtrip(self):
        gvr = b"\x42" * 32
        db = SlashingProtectionDB()
        db.check_and_insert_block_proposal(PK_A, 7, ROOT_1)
        db.check_and_insert_attestation(PK_A, 1, 2, ROOT_2)
        text = db.export_json(gvr)
        db2 = SlashingProtectionDB()
        assert db2.import_json(text, gvr) == 1
        with pytest.raises(SlashingProtectionError):
            db2.check_and_insert_block_proposal(PK_A, 7, ROOT_2)
        with pytest.raises(SlashingProtectionError):
            db2.check_and_insert_attestation(PK_A, 1, 2, ROOT_1)
        with pytest.raises(SlashingProtectionError):
            db2.import_json(text, b"\x43" * 32)

    def test_interchange_matches_jax(self):
        """The same history exports the JAX package's EIP-3076 JSON, and
        each package imports the other's."""
        from lighthouse_tpu.validator_client import SlashingProtectionDB as JDB

        gvr = b"\x42" * 32
        mine, theirs = SlashingProtectionDB(), JDB()
        for db in (mine, theirs):
            db.check_and_insert_block_proposal(PK_A, 7, ROOT_1)
            db.check_and_insert_block_proposal(PK_B, 3, None)
            db.check_and_insert_attestation(PK_A, 1, 2, ROOT_2)
            db.check_and_insert_attestation(PK_B, 0, 5, None)
        assert mine.export_json(gvr) == theirs.export_json(gvr)
        assert JDB().import_json(mine.export_json(gvr), gvr) == 2
        assert SlashingProtectionDB().import_json(theirs.export_json(gvr), gvr) == 2

    def test_lockbox_persistence(self, tmp_path):
        from lighthouse_tpu_torch.store.lockbox_store import LockboxStore

        path = str(tmp_path / "slashing.db")
        store = LockboxStore(path)
        db = SlashingProtectionDB(store=store)
        db.check_and_insert_block_proposal(PK_A, 5, ROOT_1)
        db.check_and_insert_attestation(PK_A, 0, 1, ROOT_2)
        store.close()
        store2 = LockboxStore(path)
        db2 = SlashingProtectionDB(store=store2)
        with pytest.raises(SlashingProtectionError):
            db2.check_and_insert_block_proposal(PK_A, 5, ROOT_2)
        with pytest.raises(SlashingProtectionError):
            db2.check_and_insert_attestation(PK_A, 0, 1, ROOT_1)
        db2.check_and_insert_block_proposal(PK_A, 6, ROOT_2)
        store2.close()


# ----------------------------------------------------------- full VC loop


@pytest.fixture(scope="module")
def vc_setup():
    set_backend("fake")
    harness = BeaconChainHarness(validator_count=16, fake_crypto=True)
    server = HttpApiServer(harness.chain).start()
    vc = _client(harness, server, [interop_secret_key(i) for i in range(16)],
                 fake_signatures=True)
    yield harness, server, vc
    server.stop()
    set_backend("host")


def test_vc_keeps_chain_finalizing(vc_setup):
    """Five epochs driven only by the client over TCP: every slot proposed,
    one attestation per validator and epoch, the chain finalizes."""
    harness, server, vc = vc_setup
    chain, spec = harness.chain, harness.spec
    slots = spec.slots_per_epoch * 5
    proposals = attestations = 0
    for _ in range(slots):
        summary = vc.run_slot(harness.advance_slot())
        proposals += 1 if summary["proposed"] else 0
        attestations += summary["attestations"]
    assert proposals == slots
    assert attestations == 16 * 5
    assert chain.finalized_checkpoint()[0] >= 2


def test_vc_double_sign_refused(vc_setup):
    harness, server, vc = vc_setup
    slot = harness.advance_slot()
    summary = vc.run_slot(slot)
    assert summary["proposed"] is not None
    pubkey = vc.duties.proposer_at_slot(slot, harness.spec)
    parent = bytes(harness.chain.get_block(bytes.fromhex(summary["proposed"])).message.parent_root)
    state, _ = harness.chain.state_at_slot(slot, parent)
    block, _ = harness.chain.produce_block(
        slot, vc.store.randao_reveal(pubkey, slot // harness.spec.slots_per_epoch),
        graffiti=b"\xde\xad" * 16, parent_root=parent, pre_state=state.copy())
    with pytest.raises(SlashingProtectionError):
        vc.store.sign_block(pubkey, block)


def test_vc_aggregates_published(vc_setup):
    harness, server, vc = vc_setup
    total = 0
    for _ in range(4):
        total += vc.run_slot(harness.advance_slot())["aggregates"]
    assert total > 0


def test_vc_multi_bn_fallback(vc_setup):
    """First beacon node dead, the second serves; all dead raises."""
    harness, server, vc = vc_setup
    dead = BeaconNodeHttpClient("http://127.0.0.1:9", timeout=0.3)
    vc2 = ValidatorClient(
        keys=[interop_secret_key(i) for i in range(4)],
        beacon_nodes=[dead, BeaconNodeHttpClient(server.url)], spec=harness.spec,
        types=harness.types, genesis_validators_root=harness.chain.genesis_validators_root,
        fake_signatures=True)
    epoch = harness.chain.current_slot() // harness.spec.slots_per_epoch
    vc2.update_duties(epoch)
    assert vc2.duties.resolve_indices()
    all_dead = ValidatorClient(
        keys=[interop_secret_key(0)], beacon_nodes=[dead], spec=harness.spec,
        types=harness.types, genesis_validators_root=harness.chain.genesis_validators_root,
        fake_signatures=True)
    with pytest.raises(NoViableBeaconNode):
        all_dead.update_duties(epoch)


def test_vc_sync_committee_duties(vc_setup):
    """Sync messages at +1/3, contributions at +2/3; the pooled
    contributions reach the next block's sync aggregate."""
    harness, server, vc = vc_setup
    slot = harness.advance_slot()
    summary = vc.run_slot(slot)
    assert summary["sync_messages"] > 0
    assert summary["sync_contributions"] > 0
    head_root = harness.chain.head_root
    assert any(k[0] == slot and k[1] == head_root
               for k in harness.chain.sync_contribution_pool._pool)
    next_slot = harness.advance_slot()
    block, _ = harness.chain.produce_block(
        next_slot, randao_reveal=harness.randao_reveal(
            harness.chain.head_state, next_slot,
            h.get_beacon_proposer_index(harness.chain.state_at_slot(next_slot)[0],
                                        harness.spec)))
    assert any(block.body.sync_aggregate.sync_committee_bits)


def test_preparation_service_routes_fee_recipient(vc_setup):
    set_backend("fake")
    harness, server, vc = vc_setup
    chain = harness.chain
    recipient = b"\x42" * 20
    vc.preparation.fee_recipient = recipient
    assert vc.preparation.prepare() == 16
    assert chain.proposer_preparations
    assert all(r == recipient for r in chain.proposer_preparations.values())
    summary = vc.run_slot(harness.advance_slot())
    assert summary["proposed"] is not None
    head = chain.get_block(chain.head_root)
    assert bytes(head.message.body.execution_payload.fee_recipient) == recipient


def test_graffiti_file_flows_into_block(vc_setup, tmp_path):
    from lighthouse_tpu_torch.validator_client.graffiti_file import GraffitiFile

    set_backend("fake")
    harness, server, vc = vc_setup
    path = tmp_path / "graffiti.txt"
    path.write_text("default: from-the-file\n")
    vc.blocks.graffiti_file = GraffitiFile(str(path))
    try:
        assert vc.run_slot(harness.advance_slot())["proposed"] is not None
        head = harness.chain.get_block(harness.chain.head_root)
        assert bytes(head.message.body.graffiti).rstrip(b"\x00") == b"from-the-file"
    finally:
        vc.blocks.graffiti_file = None


def test_latency_measurement(vc_setup):
    from lighthouse_tpu_torch.validator_client.services import BeaconNodeFallback

    harness, server, vc = vc_setup
    dead = BeaconNodeHttpClient("http://127.0.0.1:1")
    dead.timeout = 0.3
    out = BeaconNodeFallback([vc.fallback.clients[0], dead]).measure_latency()
    assert len(out) == 2
    assert out[0]["latency"] is not None and out[0]["latency"] < 5
    assert out[1]["latency"] is None


def test_graffiti_file_precedence(tmp_path):
    from lighthouse_tpu_torch.validator_client.graffiti_file import (
        GraffitiFile,
        GraffitiFileError,
    )

    pk = b"\xab" * 48
    path = tmp_path / "graffiti.txt"
    path.write_text(f"# comment\ndefault: team default\n0x{pk.hex()}: my very own\n")
    gf = GraffitiFile(str(path))
    assert gf.graffiti_for(pk) == b"my very own".ljust(32, b"\x00")
    assert gf.graffiti_for(b"\xcd" * 48) == b"team default".ljust(32, b"\x00")
    path.write_text("default: changed\n")
    assert gf.graffiti_for(pk) == b"changed".ljust(32, b"\x00")
    for bad in ("not a mapping\n", "0x1234: short pubkey\n", "default: " + "x" * 33 + "\n"):
        path.write_text(bad)
        with pytest.raises(GraffitiFileError):
            gf.graffiti_for(pk)


# ---------------------------------------------------------- doppelganger


def _doppelganger_rig():
    set_backend("fake")
    harness = BeaconChainHarness(validator_count=16, fake_crypto=True)
    server = HttpApiServer(harness.chain).start()
    vc = _client(harness, server, [interop_secret_key(i) for i in range(4)],
                 fake_signatures=True)
    return harness, server, vc


def test_doppelganger_blocks_until_clean_epochs():
    harness, server, vc = _doppelganger_rig()
    try:
        spe = harness.spec.slots_per_epoch
        vc.enable_doppelganger_protection(0)
        assert not vc.store.signing_enabled
        for _ in range(spe):
            s = vc.run_slot(harness.advance_slot())
            assert s["proposed"] is None and s["attestations"] == 0
        vc.run_slot(harness.advance_slot())
        assert not vc.store.signing_enabled
        for _ in range(spe - 1):
            harness.advance_slot()
        vc.run_slot(harness.advance_slot())
        assert not vc.store.signing_enabled
        for _ in range(spe - 1):
            harness.advance_slot()
        vc.run_slot(harness.advance_slot())
        assert vc.store.signing_enabled
        for _ in range(spe - 1):
            vc.run_slot(harness.advance_slot())
        vc.run_slot(harness.advance_slot())
        assert vc.store.signing_enabled, "gate re-latched on own liveness"
        assert not vc.doppelganger.detected
    finally:
        server.stop()
        set_backend("host")


def test_doppelganger_detects_live_validator():
    from lighthouse_tpu_torch.validator_client.validator_store import DoppelgangerBlocked

    harness, server, vc = _doppelganger_rig()
    try:
        spe = harness.spec.slots_per_epoch
        vc.enable_doppelganger_protection(0)
        for _ in range(spe):
            harness.advance_slot()
        harness.extend_chain(spe, attest=True)
        slot = harness.advance_slot()
        assert slot // spe == 2
        vc.run_slot(slot)
        assert vc.doppelganger.detected
        assert not vc.store.signing_enabled
        with pytest.raises(DoppelgangerBlocked):
            vc.store.randao_reveal(interop_secret_key(2).public_key().to_bytes(), 2)
    finally:
        server.stop()
        set_backend("host")


# ------------------------------------------------- EIP-3076 veto regression


class TestValidatorStoreVeto:
    @pytest.fixture()
    def store_setup(self):
        from lighthouse_tpu_torch.validator_client.validator_store import ValidatorStore

        set_backend("fake")
        harness = BeaconChainHarness(validator_count=4, fake_crypto=True)
        sk = interop_secret_key(0)
        store = ValidatorStore(
            keys=[sk], spec=harness.spec,
            genesis_validators_root=bytes(harness.chain.genesis_state.genesis_validators_root),
            fake_signatures=True)
        yield harness.types, store, sk.public_key().to_bytes()
        set_backend("host")

    @staticmethod
    def _att_data(types, source, target, beacon_root=b"\x01" * 32):
        return types.AttestationData(
            slot=target * 8, index=0, beacon_block_root=beacon_root,
            source=types.Checkpoint(epoch=source, root=b"\x0a" * 32),
            target=types.Checkpoint(epoch=target, root=b"\x0b" * 32))

    @staticmethod
    def _header(types, slot, graffiti_byte=0):
        return types.BeaconBlockHeader(
            slot=slot, proposer_index=0, parent_root=b"\x0c" * 32,
            state_root=bytes([graffiti_byte]) * 32, body_root=b"\x0d" * 32)

    def test_double_vote_refused_unsafe_signs(self, store_setup):
        types, store, pk = store_setup
        store.sign_attestation(pk, self._att_data(types, 2, 3, b"\xaa" * 32))
        double = self._att_data(types, 2, 3, b"\xbb" * 32)
        with pytest.raises(SlashingProtectionError):
            store.sign_attestation(pk, double)
        assert store.sign_attestation_unsafe(pk, double)

    def test_surround_refused_unsafe_signs(self, store_setup):
        types, store, pk = store_setup
        store.sign_attestation(pk, self._att_data(types, 3, 4))
        surround = self._att_data(types, 2, 5, b"\xcc" * 32)
        with pytest.raises(SlashingProtectionError):
            store.sign_attestation(pk, surround)
        assert store.sign_attestation_unsafe(pk, surround)

    def test_double_propose_refused_unsafe_signs(self, store_setup):
        types, store, pk = store_setup
        store.sign_block(pk, self._header(types, 5, 1))
        double = self._header(types, 5, 2)
        with pytest.raises(SlashingProtectionError):
            store.sign_block(pk, double)
        assert store.sign_block_unsafe(pk, double)

    def test_unsafe_does_not_poison_honest_history(self, store_setup):
        types, store, pk = store_setup
        store.sign_attestation(pk, self._att_data(types, 2, 3, b"\xaa" * 32))
        store.sign_attestation_unsafe(pk, self._att_data(types, 0, 9, b"\xbb" * 32))
        store.sign_attestation(pk, self._att_data(types, 3, 4))
        store.sign_block(pk, self._header(types, 7, 1))
        store.sign_block_unsafe(pk, self._header(types, 7, 2))
        store.sign_block(pk, self._header(types, 8, 3))


# ------------------------------------------------------------------ parity


def _recording(vc):
    """The attestations ``vc`` submits, as SSZ bytes, in order."""
    sent = []
    client = vc.fallback.clients[0]
    submit = client.submit_attestations

    def record(atts):
        sent.extend(a.as_ssz_bytes() for a in atts)
        return submit(atts)

    client.submit_attestations = record
    return sent


def test_vc_parity_with_jax_for_one_epoch():
    """Each package's client drives its own package's served harness for
    one epoch: the same block roots slot by slot, the same attestation
    bytes, the same EIP-3076 interchange JSON."""
    from lighthouse_tpu.consensus.genesis import interop_secret_key as j_key
    from lighthouse_tpu.http_api import BeaconNodeHttpClient as JClient
    from lighthouse_tpu.http_api import HttpApiServer as JServer
    from lighthouse_tpu.validator_client import ValidatorClient as JClientVC

    jhs, phs = harnesses({}, validators=16)
    jserver, pserver = JServer(jhs.chain).start(), HttpApiServer(phs.chain).start()
    try:
        jvc = JClientVC(keys=[j_key(i) for i in range(16)], beacon_nodes=[JClient(jserver.url)],
                        spec=jhs.spec, types=jhs.types,
                        genesis_validators_root=jhs.chain.genesis_validators_root,
                        fake_signatures=True)
        pvc = _client(phs, pserver, [interop_secret_key(i) for i in range(16)],
                      fake_signatures=True)
        j_sent, p_sent = _recording(jvc), _recording(pvc)
        j_roots, p_roots = [], []
        for _ in range(phs.spec.slots_per_epoch):
            jbackends.set_backend("fake")
            j_slot = jhs.advance_slot()
            j_roots.append(jvc.run_slot(j_slot))
            set_backend("fake")
            p_slot = phs.advance_slot()
            p_roots.append(pvc.run_slot(p_slot))
            assert j_slot == p_slot
        assert [s["proposed"] for s in p_roots] == [s["proposed"] for s in j_roots]
        assert all(s["proposed"] for s in p_roots)
        assert p_roots == j_roots
        assert phs.chain.head_root == jhs.chain.head_root
        assert p_sent == j_sent and len(p_sent) == 16
        gvr = phs.chain.genesis_validators_root
        assert pvc.store.slashing_db.export_json(gvr) == jvc.store.slashing_db.export_json(gvr)
    finally:
        jserver.stop()
        pserver.stop()
        set_backend("host")


# ------------------------------------------------------------- real crypto


def test_vc_real_crypto_slot_and_remote_signer():
    """One slot of real BLS on the ``"host"`` backend over TCP, four keys
    (the slot's proposer among them; two held by a ``MockWeb3Signer``): the
    client's block is the head, its attestations and sync messages
    accepted; the remote keys sign byte for byte as the local keys do."""
    from lighthouse_tpu_torch.validator_client.web3signer import (
        MockWeb3Signer,
        Web3SignerClient,
    )

    set_backend("host")
    harness = BeaconChainHarness(validator_count=16, fake_crypto=False)
    server = HttpApiServer(harness.chain).start()
    slot = harness.advance_slot()
    proposer = h.get_beacon_proposer_index(harness.chain.state_at_slot(slot)[0], harness.spec)
    ours = [proposer] + [i for i in range(16) if i != proposer][:3]
    keys = [interop_secret_key(i) for i in ours]
    local, remote = keys[:2], keys[2:]
    signer = MockWeb3Signer(remote).start()
    try:
        vc = ValidatorClient(
            keys=local, beacon_nodes=[BeaconNodeHttpClient(server.url, timeout=120.0)],
            spec=harness.spec, types=harness.types,
            genesis_validators_root=harness.chain.genesis_validators_root)
        web3signer = Web3SignerClient(signer.url)
        for sk in remote:
            vc.store.add_remote_key(sk.public_key().to_bytes(), web3signer)
        summary = vc.run_slot(slot)
        assert summary["proposed"] is not None
        assert harness.chain.head_root.hex() == summary["proposed"]
        assert summary["attestations"] >= 1
        assert signer.sign_requests > 0
        root = b"\x13" * 32
        for sk in remote:
            assert vc.store._raw_sign(sk.public_key().to_bytes(), root) == sk.sign(root).to_bytes()
    finally:
        signer.stop()
        server.stop()


# --------------------------------------------------- web3signer faults


class TestSignerRequestFault:
    def test_sign_retries_once_on_connection_error(self):
        from lighthouse_tpu_torch.crypto.bls import api as bls
        from lighthouse_tpu_torch.validator_client.web3signer import (
            MockWeb3Signer,
            Web3SignerClient,
        )

        sk = bls.SecretKey.random()
        signer = MockWeb3Signer([sk]).start()
        try:
            client = Web3SignerClient(signer.url, backoff_s=0.01)
            before = metrics.WEB3SIGNER_RETRIES.get(kind="sign")
            fi.install("signer.request", "error", first_n=1)
            root = b"\x22" * 32
            assert client.sign(sk.public_key().to_bytes(), root) == sk.sign(root).to_bytes()
            assert metrics.WEB3SIGNER_RETRIES.get(kind="sign") == before + 1
        finally:
            signer.stop()

    def test_sign_fails_after_retries_exhausted(self):
        from lighthouse_tpu_torch.validator_client.web3signer import (
            Web3SignerClient,
            Web3SignerError,
        )

        client = Web3SignerClient("http://127.0.0.1:9", timeout=0.2, backoff_s=0.01)
        fi.install("signer.request", "error")
        with pytest.raises(Web3SignerError, match="unreachable"):
            client.sign(b"\x01" * 48, b"\x02" * 32)

    def test_metric_rendered(self):
        assert "web3signer_retries_total" in "\n".join(metrics.WEB3SIGNER_RETRIES.render())


# ------------------------------------------------- the [vc] phase on the CPU


@pytest.mark.slow
def test_chip_smoke_vc_phase_on_cpu(monkeypatch, tmp_path):
    """``chip_smoke``'s ``[http]`` then ``[vc]`` on the CPU, on one server: a
    4,096-validator block import case (no blobs) imported by a
    checkpoint-synced node, then every gate of both phases on the
    ``"torch"`` backend's plain versions (stand-ins count their launches)."""
    import chip_smoke
    from lighthouse_tpu_torch import workload
    from lighthouse_tpu_torch.chain import BeaconChain, ManualSlotClock
    from lighthouse_tpu_torch.chain.mock_el import MockExecutionEngine
    from lighthouse_tpu_torch.ops import cuda_fq

    for name in ("fq_mul", "fq2_mul"):
        plain = getattr(cuda_fq, f"{name}_plain")

        def counted(a, b, name=name, plain=plain):
            cuda_fq.LAUNCHES[name] += 1
            return plain(a, b)

        monkeypatch.setattr(cuda_fq, f"{name}_plain", counted)
    monkeypatch.setenv("LIGHTHOUSE_TPU_FORCE_PROFILER", "1")
    set_backend("torch")
    served = None
    try:
        case = workload.block_import_case(4096, seed=0xB10C, blob_commitments=[])
        workload.warm_pubkey_cache(case.keys)
        signed, spec = case.signed_block, case.spec
        clock = ManualSlotClock(int(case.pre_state.genesis_time), spec.seconds_per_slot)
        clock.set_slot(int(signed.message.slot))
        chain = BeaconChain(genesis_state=case.pre_state, types=case.types, spec=spec,
                            slot_clock=clock, execution_engine=MockExecutionEngine())
        chain.process_block(signed)
        served = chip_smoke.api_server(chain)
        http_out = chip_smoke.phase_http("cpu", case, chain, [],
                                         case.host_state.as_ssz_bytes(), served,
                                         device="cpu")
        out = chip_smoke.phase_vc("cpu", case, chain, clock, served, str(tmp_path))
    finally:
        if served is not None:
            served[0].stop()
            served[1].shutdown()
        set_backend("host")
    assert min(http_out["launches"].values()) > 0
    assert out["summary"]["attestations"] == chip_smoke.VC_KEYS
    assert out["summary"]["proposed"] is None
    assert min(out["launches"].values()) > 0
    assert out["shed"] == 0
