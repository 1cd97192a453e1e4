"""The port's chain core (``chain/``, ``op_pool/``, ``store/``) vs the JAX
package's.

``lighthouse_tpu_torch.chain`` copies the JAX package's ``chain/`` (its
``rewards.py`` and the builder path excepted).  Chains are both packages'
``BeaconChainHarness`` (minimal preset, fake crypto unless a test says
otherwise) on the port's CPU routes: host tree hashing, the numpy epoch
backend and, for real crypto, the ``"torch"`` backend on the CPU (the CUDA
kernels' plain versions).  Both harnesses get the same user graffiti: with
none, a produced block carries the client version, which differs between
the packages.  Every comparison is exact:

- harness parity, for a few fork schedules across epoch boundaries to
  finality: every block root, every post-state's bytes, the head,
  justified and finalized checkpoints, and the whole ``MemoryStore`` and
  freezer content (every column, key and value); a fork resolved by
  attestation weight lands on the same head with the same weights;
- a checkpoint-synced chain whose anchor lies past the history window
  imports forward (the JAX package's copy rewinds the anchor in its first
  migration; the port starts the store's split at the anchor);
- the default route: a real-crypto harness with no device configured
  raises where there is no card, before the chain or the store changes;
- ``[chain]``'s input (``workload.block_import_case``) at 4,096
  validators: a checkpoint-synced node on a lockbox store imports the
  block through ``process_block`` to the host run's state, and refuses a
  block with two attestation signatures swapped and a copy that carries a
  blob commitment without its sidecar, its head, store and caches
  unchanged;
- the JAX package's ``test_chain_harness.py``, ``test_fork_revert.py``,
  ``test_reorg_attester_cache.py``, ``test_otb_verification.py`` and
  ``test_chain_services.py`` cases re-pointed at the port, and its
  ``test_device_chain.py`` cases on the ``"torch"`` backend on the CPU.
"""

import contextlib
import copy

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu.chain import BeaconChainHarness as JHarness  # noqa: E402
from lighthouse_tpu.chain.graffiti_calculator import GraffitiOrigin as JGraffitiOrigin  # noqa: E402
from lighthouse_tpu.consensus import helpers as jh  # noqa: E402
from lighthouse_tpu.crypto.bls import backends as jbackends  # noqa: E402
from lighthouse_tpu.types.spec import minimal_spec as j_minimal_spec  # noqa: E402
from lighthouse_tpu_torch import workload  # noqa: E402
from lighthouse_tpu_torch.chain import (  # noqa: E402
    AttestationError,
    BeaconChainHarness,
    BlockError,
)
from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain  # noqa: E402
from lighthouse_tpu_torch.chain.fork_readiness import (  # noqa: E402
    fork_readiness,
    next_scheduled_fork,
)
from lighthouse_tpu_torch.chain.fork_revert import (  # noqa: E402
    ForkRevertError,
    revert_to_fork_boundary,
)
from lighthouse_tpu_torch.chain.graffiti_calculator import GraffitiOrigin  # noqa: E402
from lighthouse_tpu_torch.chain.harness import interop_genesis_state  # noqa: E402
from lighthouse_tpu_torch.chain.mock_el import MockExecutionEngine  # noqa: E402
from lighthouse_tpu_torch.chain.otb_verification import verify_otbs  # noqa: E402
from lighthouse_tpu_torch.chain.slot_clock import ManualSlotClock  # noqa: E402
from lighthouse_tpu_torch.consensus import helpers as h  # noqa: E402
from lighthouse_tpu_torch.consensus import per_epoch as pe  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import backends as pbackends  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend, torch_backend  # noqa: E402
from lighthouse_tpu_torch.fork_choice.fork_choice import DoNotReOrg  # noqa: E402
from lighthouse_tpu_torch.ops import tree_hash as th  # noqa: E402
from lighthouse_tpu_torch.store import HotColdDB, LockboxStore  # noqa: E402
from lighthouse_tpu_torch.types.spec import minimal_spec  # noqa: E402

VALIDATORS = 64
#: The user graffiti both packages' harness chains carry.
GRAFFITI = b"lighthouse parity".ljust(32, b"\x00")
_NO_LATER = dict(altair_fork_epoch=None, bellatrix_fork_epoch=None,
                 capella_fork_epoch=None, deneb_fork_epoch=None, electra_fork_epoch=None)
#: Fork schedules for harness parity: the harness's default (capella from
#: genesis), phase0 into altair at the first boundary, and deneb into
#: electra at the second.
SCHEDULES = {
    "capella": {},
    "phase0-altair": dict(_NO_LATER, altair_fork_epoch=1),
    "deneb-electra": dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
                          deneb_fork_epoch=0, electra_fork_epoch=2),
}
#: Slots to finality on the minimal preset (five epochs).
FINALITY_SLOTS = 40


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def port_cpu():
    """The port's CPU routes (host tree hashing, the numpy epoch backend,
    the ``"torch"`` BLS backend on the CPU); the JAX package's backend and
    the port's card defaults come back afterwards."""
    j_prev = jbackends.backend_name()
    th.configure(enabled=False)
    pe.configure(backend="numpy")
    set_backend("torch")
    torch_backend.configure(device="cpu")
    yield
    jbackends.set_backend(j_prev)
    pbackends._ACTIVE = pbackends._NAME = None
    torch_backend.reset_for_tests()
    pe.reset_for_tests()
    th.reset_for_tests()


@contextlib.contextmanager
def jax_backend(name):
    prev = jbackends.backend_name()
    jbackends.set_backend(name)
    try:
        yield
    finally:
        jbackends.set_backend(prev)


def specs(overrides):
    """The JAX package's and the port's harness spec with ``overrides``
    (the harness's default schedule: capella from genesis, no deneb)."""
    base = dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
                deneb_fork_epoch=None)
    base.update(overrides)
    return j_minimal_spec(**base), minimal_spec(**base)


def harnesses(overrides, validators: int = VALIDATORS):
    """Both packages' fake-crypto harnesses with the same spec and graffiti."""
    j_spec, p_spec = specs(overrides)
    with jax_backend("fake"):
        jhs = JHarness(validator_count=validators, spec=j_spec, fake_crypto=True)
    jhs.chain.graffiti_calculator.beacon_graffiti = JGraffitiOrigin.user(GRAFFITI)
    phs = BeaconChainHarness(validator_count=validators, spec=p_spec, fake_crypto=True)
    phs.chain.graffiti_calculator.beacon_graffiti = GraffitiOrigin.user(GRAFFITI)
    return jhs, phs


def store_content(chain) -> dict:
    """Every column, key and value of a harness chain's hot and cold
    MemoryStores."""
    return {"hot": chain.db.hot._data, "cold": chain.db.cold._data}


@pytest.fixture()
def harness():
    """The re-pointed cases' chain: 16 validators, fake crypto."""
    return BeaconChainHarness(validator_count=16, fake_crypto=True)


def checkpoints(chain) -> tuple:
    return chain.head_root, chain.justified_checkpoint(), chain.finalized_checkpoint()


# ------------------------------------------------------------ harness parity


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_harness_chain_matches_jax(schedule):
    """Both harnesses extended slot by slot to finality: the same block
    root and post-state bytes at every slot, the same checkpoints, the same
    store content."""
    jhs, phs = harnesses(SCHEDULES[schedule])
    forks = set()
    with jax_backend("fake"):
        for _ in range(FINALITY_SLOTS):
            (j_root,) = jhs.extend_chain(1)
            (p_root,) = phs.extend_chain(1)
            assert p_root == j_root
            p_state = phs.head_state
            assert p_state.as_ssz_bytes() == jhs.head_state.as_ssz_bytes()
            forks.add(type(p_state).fork_name)
    assert checkpoints(phs.chain) == checkpoints(jhs.chain)
    assert phs.finalized_epoch() >= 3
    assert phs.chain.db.get_split_slot() == jhs.chain.db.get_split_slot() > 0
    assert store_content(phs.chain) == store_content(jhs.chain)
    assert len(forks) == (1 if schedule == "capella" else 2)


def fork_by_weight(hs, helpers, process):
    """The fork of ``test_fork_resolves_by_weight``: two blocks at slot 3,
    the committee of slot 3 votes for the second; returns the heads before
    and after the votes and the fork choice's node weights."""
    roots = hs.extend_chain(2, attest=False)
    hs.advance_slot()
    canonical = hs.produce_signed_block(slot=3)
    fork_block = hs.produce_signed_block(slot=3, parent_root=roots[0], graffiti=b"\x42" * 32)
    process(canonical)
    f_root = process(fork_block)
    before = hs.head_root
    state, spec = hs.chain.get_state(f_root), hs.spec
    committee = helpers.get_beacon_committee(state, 3, 0, spec)
    epoch = helpers.compute_epoch_at_slot(3, spec)
    data = hs.types.AttestationData(
        slot=3, index=0, beacon_block_root=f_root,
        source=state.current_justified_checkpoint.copy(),
        target=hs.types.Checkpoint(epoch=epoch, root=hs.chain.fork_choice.proto.ancestor_at_slot(
            f_root, helpers.compute_start_slot_at_epoch(epoch, spec))))
    for pos, vidx in enumerate(committee):
        bits = [False] * len(committee)
        bits[pos] = True
        hs.chain.process_attestation(hs.types.Attestation(
            aggregation_bits=bits, data=data,
            signature=hs.sign_attestation_data(state, data, int(vidx)).to_bytes()))
    hs.advance_slot()
    proto = hs.chain.fork_choice.proto
    return before, hs.head_root, f_root, {n.root: n.weight for n in proto.nodes}


def test_fork_resolved_by_weight_matches_jax():
    jhs, phs = harnesses({}, validators=16)
    with jax_backend("fake"):
        j_out = fork_by_weight(jhs, jh, lambda b: jhs.chain.process_block(b, block_delay_seconds=1.0))
    p_out = fork_by_weight(phs, h, lambda b: phs.chain.process_block(b, block_delay_seconds=1.0))
    assert p_out == j_out
    before, after, f_root, _ = p_out
    assert before != f_root and after == f_root


def test_checkpoint_synced_chain_imports_past_history_window():
    """An anchor past the minimal preset's 64-slot history window (the
    finalized state of a 12-epoch chain): the port's node imports the
    canonical blocks after it to the same head, its store's split at the
    anchor."""
    hs = BeaconChainHarness(validator_count=16, fake_crypto=True)
    hs.extend_chain(12 * hs.spec.slots_per_epoch)
    _, f_root = hs.chain.finalized_checkpoint()
    anchor = hs.chain.get_state(f_root).copy()
    assert int(anchor.slot) > hs.spec.preset.slots_per_historical_root
    clock = ManualSlotClock(hs.chain.genesis_time, hs.spec.seconds_per_slot)
    clock.set_slot(hs.chain.current_slot())
    node = BeaconChain(genesis_state=anchor, types=hs.types, spec=hs.spec, slot_clock=clock,
                       anchor_block=hs.chain.get_block(f_root))
    assert node.db.get_split_slot() == int(anchor.slot)
    roots = [hs.chain.block_root_at_slot(s)
             for s in range(int(anchor.slot) + 1, hs.chain.current_slot() + 1)]
    for root in dict.fromkeys(roots):
        node.process_block(hs.chain.get_block(root))
    assert node.head_root == hs.chain.head_root
    assert node.head_state.as_ssz_bytes() == hs.head_state.as_ssz_bytes()


# ------------------------------------------------------------ the card default


def test_default_route_raises_without_card():
    """With no device configured, the real-crypto harness's first import
    verifies on the card and raises where there is none, before the chain
    or its store changes; with every default, so does the harness's
    genesis root."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    torch_backend.reset_for_tests()
    hs = BeaconChainHarness(validator_count=16)
    chain = hs.chain
    hs.advance_slot()
    signed = hs.produce_signed_block(sync_participation=False)
    before = (checkpoints(chain), copy.deepcopy(store_content(chain)), sorted(chain._blocks))
    with pytest.raises(RuntimeError, match="cuda"):
        chain.process_block(signed)
    assert (checkpoints(chain), store_content(chain), sorted(chain._blocks)) == before
    th.reset_for_tests()
    pe.reset_for_tests()
    with pytest.raises(RuntimeError, match="cuda"):
        BeaconChainHarness(validator_count=16)


# ------------------------------------------------- [chain]'s input at 4,096


def test_chain_case_imports_on_cpu(tmp_path):
    """``[chain]``'s node on the CPU: a 4,096-validator block import case
    without blobs, the node checkpoint-synced on its pre-state over a
    lockbox store; ``process_block`` reaches the host run's state; a block
    with two attestation signatures swapped and a copy carrying a blob
    commitment without its sidecar are refused, the node unchanged."""
    case = workload.block_import_case(4096, seed=0xB10C, blob_commitments=[])
    workload.warm_pubkey_cache(case.keys)
    signed, types, spec = case.signed_block, case.types, case.spec
    block = signed.message
    anchor = case.pre_state
    clock = ManualSlotClock(int(anchor.genesis_time), spec.seconds_per_slot)
    clock.set_slot(int(block.slot))
    store = LockboxStore(str(tmp_path / "chain.db"))
    try:
        chain = BeaconChain(genesis_state=anchor, types=types, spec=spec,
                            db=HotColdDB(hot=store), slot_clock=clock,
                            execution_engine=MockExecutionEngine())
        assert chain.genesis_block_root == bytes(block.parent_root)
        root = chain.process_block(signed)
        assert root == chain.head_root == block.hash_tree_root()
        assert chain.head_state.as_ssz_bytes() == case.host_state.as_ssz_bytes()

        def snapshot():
            return (chain.head_root, int(store._lib.lockbox_count(store._h)),
                    sorted(chain._blocks), sorted(chain._states),
                    chain.early_attester_cache._item["block_root"])

        before = snapshot()
        message = copy.deepcopy(block)
        atts = message.body.attestations
        atts[0].signature, atts[1].signature = bytes(atts[1].signature), bytes(atts[0].signature)
        with pytest.raises(BlockError, match="bulk signature verification failed"):
            chain.process_block(workload.resign(case, message))
        assert snapshot() == before
        message = copy.deepcopy(block)
        message.body.blob_kzg_commitments = [next(iter(case.keys.points))]
        with pytest.raises(BlockError, match="pending availability"):
            chain.process_block(workload.resign(case, message))
        assert snapshot() == before
    finally:
        store.close()


# --------------------------------------- test_device_chain.py, on the port


WIDTH = 64  # small blobs keep host-side poly math fast


def _blob(i: int) -> bytes:
    return b"".join(((i * WIDTH + j) % 251).to_bytes(32, "big") for j in range(WIDTH))


def _count_device_calls(monkeypatch):
    """Count invocations of the device batch-verify program."""
    import lighthouse_tpu_torch.ops.verify as ov

    calls = {"n": 0, "sets": 0}
    real = ov.verify_signature_sets_device

    def counting(sets, seed=None, device=None):
        calls["n"] += 1
        calls["sets"] += len(sets)
        return real(sets, seed=seed, device=device)

    monkeypatch.setattr(ov, "verify_signature_sets_device", counting)
    return calls


def test_block_import_through_device_backend(monkeypatch):
    """Real-crypto block production -> process_block with the torch backend
    (on the CPU): the bulk signature verification of the import pipeline
    runs on the device program, and the chain head advances."""
    assert pbackends.backend_name() == "torch"
    calls = _count_device_calls(monkeypatch)
    harness = BeaconChainHarness(validator_count=8, fake_crypto=False)
    roots = harness.extend_chain(2, attest=True)
    assert harness.chain.head_root == roots[-1]
    assert calls["n"] > 0, "no signature set went through the device program"
    assert calls["sets"] >= 4, "expected proposal+randao (+attestations) sets"


def test_blob_block_import_through_device_kzg(monkeypatch):
    """Deneb block with blobs: DA verification through the device KZG
    program AND block signatures through the torch backend, both on the
    CPU: the full device path in one import."""
    import dataclasses

    import lighthouse_tpu_torch.ops.kzg_device as kd
    from lighthouse_tpu_torch.crypto.kzg.kzg import Kzg, TrustedSetup
    from lighthouse_tpu_torch.types.spec import MINIMAL_PRESET

    kzg_calls = {"n": 0}
    real_kzg = kd.verify_kzg_proof_batch_device

    def counting_kzg(*a, **kw):
        kzg_calls["n"] += 1
        return real_kzg(*a, **kw)

    monkeypatch.setattr(kd, "verify_kzg_proof_batch_device", counting_kzg)
    setup = TrustedSetup.insecure_dev_setup(width=WIDTH)
    spec = minimal_spec(
        preset=dataclasses.replace(MINIMAL_PRESET, field_elements_per_blob=WIDTH),
        altair_fork_epoch=0, bellatrix_fork_epoch=0,
        capella_fork_epoch=0, deneb_fork_epoch=0,
    )
    harness = BeaconChainHarness(validator_count=8, spec=spec, fake_crypto=False,
                                 kzg=Kzg(setup, device="cpu"))
    harness.advance_slot()
    # two blobs: a single blob short-circuits to the host single-proof
    # path; the device program is the BATCH path
    signed, sidecars = harness.produce_signed_block_with_blobs([_blob(3), _blob(4)])
    root = harness.chain.process_block_with_blobs(signed, sidecars)
    assert harness.chain.get_block(root) is not None
    assert kzg_calls["n"] > 0, "blob DA did not use the device KZG program"


def test_device_stage_histograms_populated():
    """The four device-stage timers (setup / dispatch / block-until-ready /
    verdict) record during a device-path verification, and the same
    instrumentation points put stage spans with batch-size/bucket fields
    into the block-import trace."""
    from lighthouse_tpu_torch import metrics, tracing

    before = {
        "setup": metrics.DEVICE_BATCH_SETUP_SECONDS.stats()[0],
        "dispatch": metrics.DEVICE_DISPATCH_SECONDS.stats()[0],
        "ready": metrics.DEVICE_BLOCK_UNTIL_READY_SECONDS.stats()[0],
        "verdict": metrics.DEVICE_VERDICT_SECONDS.stats()[0],
    }
    harness = BeaconChainHarness(validator_count=8, fake_crypto=False)
    harness.extend_chain(1, attest=False)
    assert metrics.DEVICE_BATCH_SETUP_SECONDS.stats()[0] > before["setup"]
    assert metrics.DEVICE_DISPATCH_SECONDS.stats()[0] > before["dispatch"]
    assert metrics.DEVICE_BLOCK_UNTIL_READY_SECONDS.stats()[0] > before["ready"]
    assert metrics.DEVICE_VERDICT_SECONDS.stats()[0] > before["verdict"]

    trace = tracing.TRACES.recent(root="block_import")[0]
    spans = {}

    def walk(sp):
        spans[sp.name] = sp
        for c in sp.children:
            walk(c)

    walk(trace.root)
    for stage in ("device_verify", "device_batch_setup",
                  "device_batch_dispatch", "device_batch_wait",
                  "device_batch_verdict"):
        assert stage in spans, stage
    assert spans["device_batch_setup"].fields["n_sets"] >= 1
    assert spans["device_batch_dispatch"].fields["n_bucket"] >= 1
    assert spans["device_batch_dispatch"].fields["k_bucket"] >= 1


# ------------------------------------------- test_chain_harness.py, re-pointed


class TestExtendChain:
    def test_head_follows_chain(self, harness):
        roots = harness.extend_chain(5)
        assert harness.head_root == roots[-1]
        assert int(harness.head_state.slot) == 5

    def test_skipped_slots(self, harness):
        harness.advance_slot()
        harness.advance_slot()
        harness.advance_slot()  # now at slot 3, no blocks yet
        signed = harness.produce_signed_block()
        root = harness.chain.process_block(signed, block_delay_seconds=1.0)
        assert harness.head_root == root
        assert int(harness.head_state.slot) == 3

    def test_finalizes_with_full_participation(self, harness):
        harness.extend_chain(5 * 8)  # 5 epochs (minimal: 8 slots/epoch)
        assert harness.justified_epoch() >= 4
        assert harness.finalized_epoch() >= 3
        # fork choice's view matches the head state's view
        assert harness.finalized_epoch() == int(
            harness.head_state.finalized_checkpoint.epoch
        )

    def test_no_attestations_no_finality(self, harness):
        harness.extend_chain(3 * 8, attest=False)
        assert harness.finalized_epoch() == 0
        assert harness.justified_epoch() == 0


class TestBlockRejection:
    def test_future_slot_rejected(self, harness):
        harness.advance_slot()
        signed = harness.produce_signed_block(slot=5)
        with pytest.raises(BlockError, match="future"):
            harness.chain.process_block(signed)

    def test_unknown_parent_rejected(self, harness):
        harness.extend_chain(2)
        signed = harness.produce_signed_block(slot=3)
        signed.message.parent_root = b"\x13" * 32
        harness.advance_slot()
        with pytest.raises(BlockError, match="parent"):
            harness.chain.process_block(signed)

    def test_bad_state_root_rejected(self, harness):
        harness.advance_slot()
        signed = harness.produce_signed_block()
        signed.message.state_root = b"\x77" * 32
        with pytest.raises(BlockError):
            harness.chain.process_block(signed)

    def test_duplicate_import_noop(self, harness):
        roots = harness.extend_chain(2)
        signed = harness.chain.get_block(roots[-1])
        assert harness.chain.process_block(signed) == roots[-1]

    def test_invalid_payload_rejected(self, harness):
        harness.extend_chain(1)
        harness.advance_slot()
        signed = harness.produce_signed_block()
        bad_hash = bytes(signed.message.body.execution_payload.block_hash)
        harness.chain.execution_engine.invalid_hashes.add(bad_hash)
        with pytest.raises(BlockError, match="rejected"):
            harness.chain.process_block(signed)


class TestAttestations:
    def test_pool_aggregates_into_blocks(self, harness):
        harness.extend_chain(1)
        n = harness.attest_to_head()
        assert n > 0
        harness.advance_slot()
        signed = harness.produce_signed_block()
        atts = list(signed.message.body.attestations)
        assert len(atts) >= 1
        # all committee members' bits merged into one aggregate
        total_bits = sum(sum(1 for b in a.aggregation_bits if b) for a in atts)
        assert total_bits == n

    def test_unknown_head_rejected(self, harness):
        harness.extend_chain(1)
        data = harness.chain.produce_attestation_data(1, 0)
        data.beacon_block_root = b"\x13" * 32
        import lighthouse_tpu_torch.consensus.helpers as h

        state = harness.head_state
        committee = h.get_beacon_committee(state, 1, 0, harness.spec)
        att = harness.types.Attestation(
            aggregation_bits=[True] + [False] * (len(committee) - 1),
            data=data,
            signature=harness.sign_attestation_data(state, data, int(committee[0])).to_bytes(),
        )
        with pytest.raises(AttestationError):
            harness.chain.process_attestation(att)


class TestForkChoiceIntegration:
    def test_fork_resolves_by_weight(self, harness):
        import lighthouse_tpu_torch.consensus.helpers as h

        roots = harness.extend_chain(2, attest=False)
        a1 = roots[0]
        # Competing block at slot 3 building on A1 (sibling of A2's child).
        harness.advance_slot()
        canonical = harness.produce_signed_block(slot=3)
        fork_block = harness.produce_signed_block(
            slot=3, parent_root=a1, graffiti=b"\x42" * 32
        )
        c_root = harness.chain.process_block(canonical, block_delay_seconds=1.0)
        f_root = harness.chain.process_block(fork_block, block_delay_seconds=1.0)
        assert harness.head_root == c_root  # longer chain, no votes yet

        # Majority attests to the fork block: head flips next slot.
        state = harness.chain.get_state(f_root)
        spec = harness.spec
        slot = 3
        committee = h.get_beacon_committee(state, slot, 0, spec)
        epoch = h.compute_epoch_at_slot(slot, spec)
        data = harness.types.AttestationData(
            slot=slot,
            index=0,
            beacon_block_root=f_root,
            source=state.current_justified_checkpoint.copy(),
            target=harness.types.Checkpoint(
                epoch=epoch,
                root=harness.chain.fork_choice.proto.ancestor_at_slot(
                    f_root, h.compute_start_slot_at_epoch(epoch, spec)
                ),
            ),
        )
        for pos, vidx in enumerate(committee):
            bits = [False] * len(committee)
            bits[pos] = True
            att = harness.types.Attestation(
                aggregation_bits=bits,
                data=data,
                signature=harness.sign_attestation_data(state, data, int(vidx)).to_bytes(),
            )
            harness.chain.process_attestation(att)
        harness.advance_slot()  # queued votes apply, head recomputed
        assert harness.head_root == f_root


class TestRealCrypto:
    """Same pipeline, genuine BLS (small chain: bulk-verified blocks +
    attestation verification through the torch backend on the CPU)."""

    def test_extend_and_verify(self):
        harness = BeaconChainHarness(validator_count=16, fake_crypto=False)
        roots = harness.extend_chain(2, sync_participation=False, participation=[0, 1, 2, 3])
        assert harness.head_root == roots[-1]

    def test_tampered_proposer_signature_rejected(self):
        harness = BeaconChainHarness(validator_count=16, fake_crypto=False)
        harness.advance_slot()
        signed = harness.produce_signed_block(sync_participation=False)
        sig = bytearray(bytes(signed.signature))
        sig[5] ^= 0x01
        signed.signature = bytes(sig)
        with pytest.raises(BlockError, match="signature"):
            harness.chain.process_block(signed)

    def test_real_sync_aggregate(self):
        harness = BeaconChainHarness(validator_count=16, fake_crypto=False)
        roots = harness.extend_chain(1, attest=False, sync_participation=True)
        assert harness.head_root == roots[-1]


def test_state_advance_cache():
    """state_advance_timer role (reference state_advance_timer.rs): the
    pre-advanced head state serves production/attestation without re-paying
    the advance, invalidates on head change, and never leaks mutations."""
    from lighthouse_tpu_torch.crypto.bls.backends import set_backend

    set_backend("fake")
    try:
        harness = BeaconChainHarness(validator_count=16, fake_crypto=True)
        chain = harness.chain
        harness.extend_chain(2)
        next_slot = chain.current_slot() + 1

        assert chain.prepare_next_slot() is True
        assert chain.prepare_next_slot() is False  # idempotent per (head, slot)
        hits0 = chain._advance_hits
        st1, root1 = chain.state_at_slot(next_slot)
        assert chain._advance_hits == hits0 + 1
        assert int(st1.slot) == next_slot
        # the cached copy is defensive: mutate and re-fetch
        st1.balances[0] += 7
        st2, _ = chain.state_at_slot(next_slot)
        assert int(st2.balances[0]) != int(st1.balances[0])
        # equivalence with the uncached computation
        chain._advanced = None
        st3, _ = chain.state_at_slot(next_slot)
        assert st2.hash_tree_root() == st3.hash_tree_root()

        # head change invalidates (new head root keys the cache)
        chain.prepare_next_slot()
        harness.extend_chain(1)
        hits1 = chain._advance_hits
        chain.state_at_slot(chain.current_slot() + 1)
        assert chain._advance_hits == hits1  # no stale hit after head moved
    finally:
        set_backend("torch")


class TestLiveness:
    def test_block_inclusion_counts_as_live(self, harness):
        """Doppelganger liveness must OR over every observed cache — gossip
        attesters, block-included attesters, aggregators, block proposers —
        not just unaggregated gossip (ADVICE r3 medium; reference
        beacon_chain.rs:6615 validator_seen_at_epoch).  The harness imports
        attestations inside blocks, which before r4 reported is_live=false."""
        chain = harness.chain
        spe = chain.spec.slots_per_epoch
        harness.extend_chain(2 * spe)  # a full epoch of attestations in blocks
        epoch = 0
        seen = [
            i for i in range(16)
            if chain.observed.validator_seen_at_epoch(epoch, i, spe)
        ]
        # Every proposer of epoch 0 is live via the block-producer cache, and
        # every attester whose attestation landed in a block is live via the
        # block-attester cache.  With 16 validators and a full epoch, a
        # majority must register.
        assert len(seen) >= 8, f"only {seen} read live"
        # Simulate the common few-subnet node: attestations never arrived
        # unaggregated on gossip, only inside imported blocks.  Liveness must
        # still hold via the block-attester / block-producer caches.
        chain.observed.attesters._seen.clear()
        chain.observed.aggregators._seen.clear()
        still_seen = [
            i for i in range(16)
            if chain.observed.validator_seen_at_epoch(epoch, i, spe)
        ]
        assert len(still_seen) >= 8, (
            f"liveness lost without gossip caches: {still_seen}"
        )


def test_sync_committee_period_boundary_selection(harness):
    """At the LAST slot of a sync-committee period the signing committee is
    the state's NEXT committee (duty epoch = epoch(slot+1); reference
    sync_committee_at_next_slot, beacon_chain.rs:1288).  Mid-period slots
    use the current committee (ADVICE r3: period-boundary messages were
    rejected against the wrong committee)."""
    from types import SimpleNamespace

    chain = harness.chain
    spec = chain.spec
    spe = spec.slots_per_epoch
    period_epochs = spec.preset.epochs_per_sync_committee_period
    period_slots = period_epochs * spe

    cur, nxt = object(), object()
    state = SimpleNamespace(slot=5, current_sync_committee=cur,
                            next_sync_committee=nxt)
    assert chain._sync_committee_for_slot(state, 5) is cur
    # last slot of period 0: signs for slot+1 which is period 1 -> NEXT
    assert chain._sync_committee_for_slot(state, period_slots - 1) is nxt
    # first slot of period 1 with a state still in period 0 -> NEXT
    assert chain._sync_committee_for_slot(state, period_slots) is nxt


# ------------------------------------------- test_fork_revert.py, re-pointed


def test_reset_fork_choice_to_finalization(harness):
    chain = harness.chain
    spe = harness.spec.slots_per_epoch
    harness.extend_chain(spe * 5)  # enough for finality on minimal
    assert chain.finalized_checkpoint()[0] >= 1
    head_before = chain.head_root
    fin_before = chain.finalized_checkpoint()

    # Simulate an unsound persisted fork choice: replace it wholesale.
    chain.reset_fork_choice_to_finalization()

    assert chain.head_root == head_before, "canonical head must survive reset"
    fc = chain.fork_choice
    assert fc.finalized_checkpoint[1] == fin_before[1]
    # the rebuilt proto-array spans anchor..head
    assert fc.is_descendant(fin_before[1], head_before)
    # and the node still extends the chain afterwards
    harness.extend_chain(2)
    assert chain.head_root != head_before


def test_reset_fork_choice_forgets_side_branches(harness):
    chain = harness.chain
    harness.extend_chain(3)
    # a side block at slot 3's fork
    roots = list(chain._blocks)
    harness.advance_slot()
    side = harness.produce_signed_block(
        slot=chain.current_slot(), graffiti=b"\x13" * 32,
        parent_root=chain.head_root,
    )
    canon = harness.produce_signed_block(slot=chain.current_slot())
    c_root = chain.process_block(canon, block_delay_seconds=1.0)
    s_root = chain.process_block(side, block_delay_seconds=20.0)
    assert s_root in chain.fork_choice.proto.indices

    chain.reset_fork_choice_to_finalization()
    # the replay follows only the canonical ancestry: side branch forgotten
    assert s_root not in chain.fork_choice.proto.indices
    assert chain.head_root in chain.fork_choice.proto.indices
    del roots


def test_revert_to_fork_boundary():
    set_backend("fake")
    try:
        spec = minimal_spec(
            altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=2,
            deneb_fork_epoch=None,
        )
        h = BeaconChainHarness(validator_count=16, fake_crypto=True, spec=spec)
        chain = h.chain
        spe = spec.slots_per_epoch
        h.extend_chain(spe * 3)  # well past the capella boundary at slot 2*spe
        boundary = 2 * spe
        assert spec.fork_name_at_slot(chain.current_slot()) == "capella"

        root, block = revert_to_fork_boundary(chain, chain.current_slot())
        assert block is not None
        assert int(block.message.slot) < boundary
        # it is the LAST pre-fork ancestor: the child at/after the boundary
        # has it as parent on the canonical chain
        assert chain.fork_choice.is_descendant(root, chain.head_root)
    finally:
        set_backend("torch")


def test_revert_refuses_phase0():
    set_backend("fake")
    try:
        spec = minimal_spec(
            altair_fork_epoch=None, bellatrix_fork_epoch=None,
            capella_fork_epoch=None, deneb_fork_epoch=None,
        )
        h = BeaconChainHarness(validator_count=16, fake_crypto=True, spec=spec)
        h.extend_chain(2)
        with pytest.raises(ForkRevertError, match="phase0"):
            revert_to_fork_boundary(h.chain, h.chain.current_slot())
    finally:
        set_backend("torch")


class TestPreFinalizationCache:
    def test_recent_history_and_disk_hits(self, harness):
        chain = harness.chain
        spe = harness.spec.slots_per_epoch
        # prune aggressively so finalized history actually leaves fork
        # choice (default threshold keeps small proto-arrays unpruned)
        chain.fork_choice.proto.prune_threshold = 0
        harness.extend_chain(spe * 5)
        assert chain.finalized_checkpoint()[0] >= 1
        # (1) recent-history path: an old canonical root PRUNED from fork
        # choice answers from the head state's block-roots vector.
        old_root = bytes(chain.head_state.block_roots[1])
        assert not chain.fork_choice.contains_block(old_root), \
            "test needs a pruned root"
        assert chain.is_pre_finalization_block(old_root) is True
        # cached now: a second query answers from memory
        assert chain.pre_finalization_cache.contains(old_root)

        # a root fork choice still KNOWS is never classified (race guard:
        # a concurrent import must not get its attester penalized)
        known = chain.head_root
        assert chain.is_pre_finalization_block(known) is False

        # (2) disk path: a block present in the STORE but on no chain the
        # head state remembers (a pruned branch survivor).
        slot = harness.advance_slot()
        orphan = harness.produce_signed_block(slot=slot, graffiti=b"\x77" * 32)
        orphan_root = orphan.message.hash_tree_root()
        chain.db.put_block(orphan_root, orphan)
        assert chain.is_pre_finalization_block(orphan_root) is True
        assert chain.pre_finalization_cache.contains(orphan_root)

    def test_unknown_root_defers_to_lookup_then_rejects(self, harness):
        chain = harness.chain
        harness.extend_chain(2)
        mystery = b"\x5a" * 32
        assert chain.is_pre_finalization_block(mystery) is False
        # de-duplicated while the lookup is in flight
        assert chain.is_pre_finalization_block(mystery) is False
        _, in_progress = chain.pre_finalization_cache.metrics()
        assert in_progress == 1
        # sync's lookup discovered it is pre-finalization after all
        chain.pre_finalization_cache.block_rejected(mystery)
        assert chain.is_pre_finalization_block(mystery) is True

    def test_import_clears_in_progress(self, harness):
        chain = harness.chain
        harness.extend_chain(1)
        slot = harness.advance_slot()
        block = harness.produce_signed_block(slot=slot)
        root = block.message.hash_tree_root()
        assert chain.is_pre_finalization_block(root) is False  # registers lookup
        chain.process_block(block)
        _, in_progress = chain.pre_finalization_cache.metrics()
        assert in_progress == 0


# ------------------------------------------- test_reorg_attester_cache.py, re-pointed


class TestEarlyAttesterCache:
    def test_attestation_without_head_state(self, harness):
        """After import, attestation data for the new block is served from
        the early-attester cache — no head-state (or state-advance) access
        at all on the 4 s deadline path."""
        chain = harness.chain
        harness.extend_chain(3)
        slot = chain.current_slot()

        # Baseline: what the slow path would answer.
        item = chain.early_attester_cache._item
        assert item is not None and item["block_root"] == chain.head_root

        # Poison every state-access path; the early cache must not need them.
        def boom(*a, **k):
            raise AssertionError("early-attester path touched chain state")

        orig_state_at_slot = chain.state_at_slot
        chain.state_at_slot = boom
        states, chain._states = chain._states, {}
        try:
            data = chain.produce_attestation_data(slot, 0)
        finally:
            chain.state_at_slot = orig_state_at_slot
            chain._states = states
        assert bytes(data.beacon_block_root) == chain.head_root
        assert int(data.slot) == slot
        # and it matches the slow path's answer exactly
        chain.early_attester_cache.clear()
        slow = chain.produce_attestation_data(slot, 0)
        assert data.hash_tree_root() == slow.hash_tree_root()

    def test_serves_block_before_store(self, harness):
        """A verified-but-unwritten block is reachable via get_block
        (reference: the cache serves RPC for gossip-known blocks)."""
        chain = harness.chain
        harness.extend_chain(2)
        root = chain.head_root
        blk = chain._blocks.pop(root)  # simulate the store write not landed
        db_block = chain.db.get_block(root)
        if db_block is not None:
            # also hide it from the store layer
            import unittest.mock as mock
            with mock.patch.object(chain.db, "get_block", return_value=None):
                assert chain.get_block(root) is not None
        else:
            assert chain.get_block(root) is not None
        chain._blocks[root] = blk

    def test_reorg_clears_cache(self, harness):
        """A head re-org away from the cached block drops the item."""
        chain = harness.chain
        roots = harness.extend_chain(2, attest=False)
        harness.advance_slot()
        # two competing blocks at slot 3; the second one loses fork choice
        canonical = harness.produce_signed_block(slot=3)
        fork_block = harness.produce_signed_block(
            slot=3, parent_root=roots[0], graffiti=b"\x42" * 32
        )
        c_root = chain.process_block(canonical, block_delay_seconds=1.0)
        chain.process_block(fork_block, block_delay_seconds=20.0)  # no boost
        assert chain.head_root == c_root
        # the losing import populated the cache last, then recompute_head
        # saw a different head and cleared it
        assert chain.early_attester_cache._item is None


class TestProposerReOrg:
    def _weak_head_setup(self, harness):
        """Chain where the head is a fresh zero-weight block on an attested
        parent: extend (attested) then import one block nobody attests to."""
        chain = harness.chain
        harness.extend_chain(4)  # slots 1..4, attested
        slot = harness.advance_slot()  # slot 5
        late = harness.produce_signed_block(slot=slot, sync_participation=False)
        chain.process_block(late, block_delay_seconds=11.0)  # late: no boost
        return chain, late

    def test_get_proposer_head_decision(self, harness):
        chain, late = self._weak_head_setup(harness)
        late_root = late.message.hash_tree_root()
        assert chain.head_root == late_root
        next_slot = chain.current_slot() + 1
        # minimal-preset committees are tiny (2 validators/slot), so the
        # mainnet 160 % parent bar is unreachable — scale it to the rig
        parent = chain.fork_choice.get_proposer_head(
            next_slot, late_root,
            re_org_head_threshold=20, re_org_parent_threshold=50,
        )
        assert parent == bytes(late.message.parent_root)
        # an attested (strong) head refuses with HeadNotWeak semantics
        harness.attest_to_head()
        chain.slot_clock.advance_slot()
        chain.fork_choice.get_head(chain.current_slot())  # apply queued votes
        with pytest.raises(DoNotReOrg, match="not weak"):
            chain.fork_choice.get_proposer_head(
                chain.current_slot(), late_root,
                re_org_head_threshold=20, re_org_parent_threshold=50,
            )

    def test_late_block_orphaned_by_next_proposer(self, harness):
        """The full flow: produce_block builds on the PARENT of the weak
        late head, and once imported (with proposer boost) the late block is
        orphaned (reference beacon_chain.rs:4250 get_state_for_re_org)."""
        chain, late = self._weak_head_setup(harness)
        late_root = late.message.hash_tree_root()
        chain.re_org_parent_threshold = 50  # scale to the 2-validator committee
        slot = harness.advance_slot()

        # harness.produce_signed_block passes pre_state, bypassing the
        # decision — call the chain path directly to exercise it end to end:
        import lighthouse_tpu_torch.consensus.helpers as h

        state, _ = chain.state_at_slot(slot, bytes(late.message.parent_root))
        proposer = h.get_beacon_proposer_index(state, harness.spec)
        reveal = harness.randao_reveal(state, slot, proposer)
        reorg_block, _ = chain.produce_block(slot, reveal)
        assert bytes(reorg_block.parent_root) == bytes(late.message.parent_root), (
            "proposer must build on the parent, orphaning the weak late head"
        )
        signed = harness.sign_block(
            reorg_block, chain.state_at_slot(slot, bytes(reorg_block.parent_root))[0]
        )
        new_root = chain.process_block(signed, block_delay_seconds=1.0)
        assert chain.head_root == new_root
        assert not chain.fork_choice.is_descendant(late_root, new_root), (
            "the late block must be orphaned"
        )

    def test_reorg_declined_for_timely_head(self, harness):
        """head_late gate (reference beacon_chain.rs:4289-4290): a head that
        arrived BEFORE the attestation deadline is never orphaned, even when
        weakly attested (slow attestation propagation must not get honest
        blocks re-orged)."""
        chain = harness.chain
        harness.extend_chain(4)
        slot = harness.advance_slot()
        timely = harness.produce_signed_block(slot=slot, sync_participation=False)
        chain.process_block(timely, block_delay_seconds=1.0)  # before deadline
        chain.re_org_parent_threshold = 50
        next_slot = harness.advance_slot()
        # fork choice alone WOULD re-org (the head is weak)...
        parent = chain.fork_choice.get_proposer_head(
            next_slot, chain.head_root,
            re_org_head_threshold=20, re_org_parent_threshold=50,
        )
        assert parent == bytes(timely.message.parent_root)
        # ...but the chain's head_late gate declines.
        assert chain._maybe_re_org_parent(next_slot) is None

    def test_reorg_declined_when_disabled_or_late(self, harness):
        chain, late = self._weak_head_setup(harness)
        chain.re_org_parent_threshold = 50
        harness.advance_slot()
        chain.re_org_head_threshold = None  # disabled
        assert chain._maybe_re_org_parent(chain.current_slot()) is None
        chain.re_org_head_threshold = 20
        chain.slot_clock.advance_seconds(2.0)  # past the 1/12 cutoff (0.5 s)
        assert chain._maybe_re_org_parent(chain.current_slot()) is None


# ------------------------------------------- test_otb_verification.py, re-pointed


@pytest.fixture()
def premerge_harness():
    """A harness whose genesis predates the merge (empty payload header), so
    the first produced block IS the transition block."""
    set_backend("fake")
    h = BeaconChainHarness(validator_count=16, fake_crypto=True)
    genesis = interop_genesis_state(
        16, h.types, h.spec, genesis_time=h.chain.genesis_time
    )
    genesis.latest_execution_payload_header = type(
        genesis.latest_execution_payload_header
    )()
    h.chain = BeaconChain(
        genesis_state=genesis,
        types=h.types,
        spec=h.spec,
        slot_clock=ManualSlotClock(h.chain.genesis_time, h.spec.seconds_per_slot),
        execution_engine=MockExecutionEngine(),
    )
    yield h
    set_backend("torch")


def _import_transition_block_optimistically(h):
    chain = h.chain
    slot = h.advance_slot()
    block = h.produce_signed_block(slot=slot)
    payload_hash = bytes(block.message.body.execution_payload.block_hash)
    assert any(payload_hash), "first block must carry the transition payload"
    chain.execution_engine.optimistic_hashes = {payload_hash}
    root = chain.process_block(block, block_delay_seconds=1.0)
    return root, block


def test_transition_block_registered_and_verified(premerge_harness):
    h = premerge_harness
    chain = h.chain
    root, block = _import_transition_block_optimistically(h)
    assert [r for r, _ in chain.otb_store.all()] == [root]

    engine = chain.execution_engine
    pow_parent = bytes(block.message.body.execution_payload.parent_hash)

    # An EL WITHOUT the PoW lookup capability at all: undecidable, persists
    chain.execution_engine = object()
    assert verify_otbs(chain) == 0
    assert chain.otb_store.all(), "capability-less EL must leave the OTB"
    chain.execution_engine = engine

    # EL reachable but erroring: also undecidable, record survives
    engine_get = engine.get_pow_block
    engine.get_pow_block = lambda h_: (_ for _ in ()).throw(ConnectionError())
    assert verify_otbs(chain) == 0
    assert chain.otb_store.all(), "unanswerable OTB must persist"
    engine.get_pow_block = engine_get

    # EL learns the PoW parent met TTD: record resolves, block stays viable
    engine.pow_blocks[pow_parent] = {
        "total_difficulty": chain.spec.terminal_total_difficulty,
        "parent_total_difficulty": 0,
    }
    assert verify_otbs(chain) == 1
    assert chain.otb_store.all() == []
    assert chain.head_root == root


def test_pow_parent_not_found_is_undecidable(premerge_harness):
    """A missing PoW parent retries forever (reference
    TerminalPoWBlockNotFound) — the EL may be syncing; it proves nothing."""
    h = premerge_harness
    chain = h.chain
    root, _ = _import_transition_block_optimistically(h)
    assert verify_otbs(chain) == 0
    assert chain.otb_store.all(), "not-found must keep the record"
    assert chain.head_root == root


def test_invalid_transition_block_is_invalidated(premerge_harness):
    h = premerge_harness
    chain = h.chain
    root, block = _import_transition_block_optimistically(h)
    assert chain.head_root == root

    # The PoW parent EXISTS but fails the TTD check -> provably invalid:
    # fork choice must drop the block as head.
    parent = bytes(block.message.body.execution_payload.parent_hash)
    chain.execution_engine.pow_blocks[parent] = {
        "total_difficulty": chain.spec.terminal_total_difficulty - 1,
        "parent_total_difficulty": 0,
    }
    assert verify_otbs(chain) == 1
    assert chain.otb_store.all() == []
    assert chain.head_root != root, "invalid transition block kept as head"


def test_partial_el_response_is_undecidable(premerge_harness):
    h = premerge_harness
    chain = h.chain
    root, block = _import_transition_block_optimistically(h)
    parent = bytes(block.message.body.execution_payload.parent_hash)
    chain.execution_engine.pow_blocks[parent] = {
        "total_difficulty": chain.spec.terminal_total_difficulty,
        # parent_total_difficulty missing: incomplete response
    }
    assert verify_otbs(chain) == 0
    assert chain.otb_store.all(), "partial data must not resolve the OTB"
    assert chain.head_root == root


# ------------------------------------------- test_chain_services.py, re-pointed


class TestAttestationSimulator:
    def test_simulated_votes_scored_against_chain(self, harness):
        chain = harness.chain
        harness.extend_chain(2)
        chain.validator_monitor._simulated.clear()  # extend_chain pre-seeded
        for _ in range(4):
            slot = harness.advance_slot()
            block = harness.produce_signed_block(slot=slot)
            chain.process_block(block, block_delay_seconds=1.0)
            # the simulator fires at +1/3 into the slot — AFTER the block
            chain.simulate_attestation()
        stats = chain.validator_monitor.simulator_stats
        # every simulated head vote matched (the chain never re-orged)
        assert stats["head_hits"] >= 3, stats
        assert stats["head_misses"] == 0, stats

    def test_simulator_skips_while_syncing(self, harness):
        chain = harness.chain
        harness.extend_chain(1)
        spe = harness.spec.slots_per_epoch
        for _ in range(spe * 3):  # wall clock runs 3 epochs ahead of the head
            harness.advance_slot()
        chain.validator_monitor._simulated.clear()  # entries from the climb
        chain.simulate_attestation()
        assert not chain.validator_monitor._simulated, (
            "a node 2+ epochs behind must not burn old-state committees")


class TestGraffitiCalculator:
    def test_precedence_vc_then_user_then_calculated(self, harness):
        chain = harness.chain
        calc = chain.graffiti_calculator
        vc = b"from-the-vc".ljust(32, b"\x00")
        assert calc.get_graffiti(vc) == vc
        # calculated: mock EL identity + our version
        auto = calc.get_graffiti(b"\x00" * 32)
        assert b"MK" in auto and b"LH" in auto
        # operator-pinned beats calculated
        calc.beacon_graffiti = GraffitiOrigin.user(b"operator flag")
        pinned = calc.get_graffiti(None)
        assert pinned.startswith(b"operator flag")

    def test_produced_blocks_carry_calculated_graffiti(self, harness):
        chain = harness.chain
        harness.extend_chain(1)
        slot = harness.advance_slot()
        block, _ = chain.produce_block(slot, harness.randao_reveal(
            chain.state_at_slot(slot)[0], slot,
            __import__("lighthouse_tpu_torch.consensus.helpers",
                       fromlist=["h"]).get_beacon_proposer_index(
                chain.state_at_slot(slot)[0], harness.spec)))
        g = bytes(block.body.graffiti)
        assert any(g) and b"LH" in g


class TestForkReadiness:
    def test_upcoming_fork_reports_ready(self):
        set_backend("fake")
        try:
            spec = minimal_spec(
                altair_fork_epoch=0, bellatrix_fork_epoch=0,
                capella_fork_epoch=2, deneb_fork_epoch=None,
            )
            h = BeaconChainHarness(validator_count=16, fake_crypto=True,
                                   spec=spec)
            assert next_scheduled_fork(spec, 0) == ("capella", 2)
            report = fork_readiness(h.chain)
            assert report is not None and report["fork"] == "capella"
            assert report["ready"] is True  # in-proc engine is fork-complete
        finally:
            set_backend("torch")

    def test_missing_kzg_flags_not_ready_for_deneb(self):
        set_backend("fake")
        try:
            spec = minimal_spec(
                altair_fork_epoch=0, bellatrix_fork_epoch=0,
                capella_fork_epoch=0, deneb_fork_epoch=2,
            )
            h = BeaconChainHarness(validator_count=16, fake_crypto=True,
                                   spec=spec)
            h.chain.kzg = None
            report = fork_readiness(h.chain)
            assert report is not None and report["ready"] is False
            assert any("KZG" in p for p in report["problems"])
        finally:
            set_backend("torch")

    def test_no_report_outside_window(self, harness):
        # default harness spec schedules no future fork
        assert fork_readiness(harness.chain) is None

class TestValidatorMonitorDepth:
    """Sync-committee + missed-proposal tracking (validator_monitor.rs
    register_sync_aggregate_in_block / missed-block tracking)."""

    def test_sync_aggregate_tracking(self, harness):
        chain = harness.chain
        chain.validator_monitor.register(range(16))
        slot = harness.advance_slot()
        signed = harness.produce_signed_block(slot=slot)
        chain.process_block(signed)
        counters = chain.validator_monitor.validator_metrics(range(16))
        hits = sum(c.get("sync_committee_hits", 0)
                   for c in counters["validators"].values())
        misses = sum(c.get("sync_committee_misses", 0)
                     for c in counters["validators"].values())
        # a harness block carries a full sync aggregate: every DISTINCT
        # committee member scores one hit (members repeat in a 32-slot
        # committee drawn from 16 validators; participation is judged
        # per validator per block), zero misses
        distinct = len(set(
            chain._sync_committee_member_indices(chain.head_state)))
        assert hits == distinct > 0
        assert misses == 0

    def test_missed_proposal_counted_once(self, harness):
        chain = harness.chain
        chain.validator_monitor.register(range(16))
        harness.extend_chain(2)
        # skip a slot entirely; the miss is judged at a FULL slot's lag
        # (a late block landing seconds into the next slot is not a miss),
        # so advance two slots before ticking — twice, for idempotence
        skipped = harness.advance_slot()
        harness.advance_slot()
        harness.advance_slot()
        chain.per_slot_task()
        chain.per_slot_task()  # idempotent: the tick may re-fire
        from lighthouse_tpu_torch.consensus import helpers as h
        expected = h.get_beacon_proposer_index(
            chain.head_state, chain.spec, slot=skipped)
        c = chain.validator_monitor.validator_metrics([expected])
        assert c["validators"][str(expected)]["proposal_misses"] == 1

    def test_proposal_hit_counted(self, harness):
        chain = harness.chain
        chain.validator_monitor.register(range(16))
        slot = harness.advance_slot()
        signed = harness.produce_signed_block(slot=slot)
        chain.process_block(signed)
        proposer = int(signed.message.proposer_index)
        c = chain.validator_monitor.validator_metrics([proposer])
        assert c["validators"][str(proposer)]["proposal_hits"] == 1


