"""The port's block processing vs the JAX package's.

``lighthouse_tpu_torch.consensus`` copies the JAX package's ``per_block``,
``state_transition`` and ``genesis``; ``types.compare_fields`` its field
diff.  Blocks and states cross from the JAX package by their SSZ bytes
(``test_torch_types.to_port``); chains are the JAX package's
``BeaconChainHarness`` (minimal preset, 64 validators, fake crypto; both
packages' fake BLS backends).  Every comparison is exact:

- ``state_transition`` on each block of a harness chain, for every fork
  schedule from phase0 to electra, across an epoch boundary and a fork
  upgrade: the port's post-state bytes equal the JAX package's;
- invalid blocks (wrong slot, wrong proposer, bad parent root, slashed
  proposer, wrong deposit count, wrong state root, an arithmetic overflow)
  raise the same error class with the same message in both packages;
- one real-crypto block (proposal, randao, attestation and sync sets): the
  JAX package's chain verifies it on its host backend; the port's
  ``VERIFY_BULK`` through the ``"torch"`` backend on the CPU (the CUDA
  kernels' plain versions) accepts it with the same post-state, and both
  packages reject it with one signature swapped; the default route (the
  card) raises where there is none, before the state changes;
- ``interop_genesis_state`` bytes and the interop keypairs, every fork;
  the keypairs also against the in-repo published vectors, and a deposit
  of the in-repo staking-deposit-cli vectors applied with its own and with
  a foreign signature;
- ``compare_fields`` names the same diverging leaves;
- ``workload.block_import_case`` (the chip script's ``[block]`` input) at
  a small registry imports with ``VERIFY_BULK`` on the CPU to its host
  state, and a swapped attestation signature and a wrong root are refused;
  ``workload.clone_state`` copies a state as ``copy.deepcopy`` does.
"""

import contextlib
import copy
import json
import os

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu.consensus import genesis as jgenesis  # noqa: E402
from lighthouse_tpu.consensus import per_block as jpb  # noqa: E402
from lighthouse_tpu.consensus.per_slot import process_slots as j_process_slots  # noqa: E402
from lighthouse_tpu.consensus.state_transition import state_transition as j_transition  # noqa: E402
from lighthouse_tpu.crypto.bls import backends as jbackends  # noqa: E402
from lighthouse_tpu.types import compare_fields as jcf  # noqa: E402
from lighthouse_tpu.types.containers import build_types as j_build_types  # noqa: E402
from lighthouse_tpu.types.spec import minimal_spec as j_minimal_spec  # noqa: E402
from lighthouse_tpu_torch import workload  # noqa: E402
from lighthouse_tpu_torch.consensus import genesis  # noqa: E402
from lighthouse_tpu_torch.consensus import per_block as pb  # noqa: E402
from lighthouse_tpu_torch.consensus import per_epoch as pe  # noqa: E402
from lighthouse_tpu_torch.consensus import signature_sets  # noqa: E402
from lighthouse_tpu_torch.consensus.state_transition import (  # noqa: E402
    StateRootMismatch,
    state_transition,
)
from lighthouse_tpu_torch.consensus.per_slot import process_slots  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import backends as pbackends  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import torch_backend  # noqa: E402
from lighthouse_tpu_torch.ops import tree_hash as th  # noqa: E402
from lighthouse_tpu_torch.types import compare_fields as cf  # noqa: E402
from lighthouse_tpu_torch.types.containers import build_types  # noqa: E402
from lighthouse_tpu_torch.types.spec import minimal_spec  # noqa: E402
from test_torch_types import to_port  # noqa: E402

VALIDATORS = 64
GENESIS_TIME = 1_600_000_000
VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")

_NO_LATER = dict(altair_fork_epoch=None, bellatrix_fork_epoch=None,
                 capella_fork_epoch=None, deneb_fork_epoch=None, electra_fork_epoch=None)
#: Fork schedules of the minimal preset: genesis at one fork, the next at
#: epoch 1 (the chain's first boundary), and a chain born on electra.
SCHEDULES = {
    "phase0-altair": dict(_NO_LATER, altair_fork_epoch=1),
    "altair-bellatrix": dict(_NO_LATER, altair_fork_epoch=0, bellatrix_fork_epoch=1),
    "bellatrix-capella": dict(_NO_LATER, altair_fork_epoch=0, bellatrix_fork_epoch=0,
                              capella_fork_epoch=1),
    "capella-deneb": dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
                          deneb_fork_epoch=1, electra_fork_epoch=None),
    "deneb-electra": dict(electra_fork_epoch=1),
    "electra": dict(electra_fork_epoch=0),
}
#: Blocks a chain carries: past the first boundary (the minimal preset's
#: 8 slots an epoch) and two slots into the next epoch.
BLOCKS = 10
GENESIS_FORKS = {
    "phase0": dict(_NO_LATER),
    "altair": dict(_NO_LATER, altair_fork_epoch=0),
    "bellatrix": dict(_NO_LATER, altair_fork_epoch=0, bellatrix_fork_epoch=0),
    "capella": dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
                    deneb_fork_epoch=None, electra_fork_epoch=None),
    "deneb": {},
    "electra": dict(electra_fork_epoch=0),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean():
    """The host tree-hash engine, the numpy epoch backend and the fake BLS
    backend in both packages, as the JAX package's harness tests run; the
    defaults (the card, the ``"torch"`` backend) come back afterwards."""
    j_prev = jbackends.backend_name()
    th.configure(enabled=False)
    pe.configure(backend="numpy")
    pbackends.set_backend("fake")
    jbackends.set_backend("fake")
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
    return j_minimal_spec(**overrides), minimal_spec(**overrides)


def fork_of(obj) -> str:
    return type(obj.message if hasattr(obj, "message") else obj).fork_name


def port_block(signed, p_types):
    return p_types.signed_block[fork_of(signed)].from_ssz_bytes(signed.as_ssz_bytes())


def build_chain(overrides, blocks=BLOCKS):
    """(JAX genesis state, the chain's signed blocks, JAX types): a harness
    chain of ``blocks`` blocks, every slot attested."""
    j_spec, _ = specs(overrides)
    with jax_backend("fake"):
        harness = BeaconChainHarness(validator_count=VALIDATORS, spec=j_spec, fake_crypto=True,
                                     genesis_time=GENESIS_TIME)
        roots = harness.extend_chain(blocks, attest=True)
    chain = harness.chain
    return chain.genesis_state.copy(), [chain.get_block(r) for r in roots], harness.types


@pytest.fixture(scope="module")
def chains():
    return {name: build_chain(overrides) for name, overrides in SCHEDULES.items()}


def raised(fn):
    """``(class name, message)`` of what ``fn()`` raises."""
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


# --------------------------------------------------------- valid chains


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_state_transition_matches_jax(chains, schedule):
    """Each block of the chain through ``state_transition`` (``VERIFY_BULK``,
    the fake backends): the post-state bytes equal the JAX package's after
    every block, across the first boundary and the fork upgrade there."""
    ref, blocks, j_types = chains[schedule]
    j_spec, p_spec = specs(SCHEDULES[schedule])
    p_types = build_types(p_spec.preset)
    j_state, p_state = ref.copy(), to_port(ref, p_types)
    forks = set()
    for signed in blocks:
        j_state = j_transition(j_state, signed, j_types, j_spec)
        p_state = state_transition(p_state, port_block(signed, p_types), p_types, p_spec)
        forks.add(fork_of(p_state))
        assert p_state.as_ssz_bytes() == j_state.as_ssz_bytes(), (schedule, int(signed.message.slot))
    assert int(p_state.slot) > p_spec.slots_per_epoch
    assert len(forks) == (1 if schedule == "electra" else 2)


# --------------------------------------------------------- invalid blocks


def _pre(chains, k):
    """(JAX state before block ``k`` of the capella-deneb chain, the block,
    port copies of both, types and specs)."""
    ref, blocks, j_types = chains["capella-deneb"]
    j_spec, p_spec = specs(SCHEDULES["capella-deneb"])
    p_types = build_types(p_spec.preset)
    j_state = ref.copy()
    for signed in blocks[:k]:
        j_state = j_transition(j_state, signed, j_types, j_spec)
    return j_state, blocks[k], j_types, j_spec, p_types, p_spec


def _wrong_slot(state, block):
    """Nothing to change: the state is already past the block's slot."""


def _wrong_proposer(state, block):
    block.message.proposer_index = (int(block.message.proposer_index) + 1) % VALIDATORS


def _bad_parent(state, block):
    block.message.parent_root = b"\x5a" * 32


def _slashed_proposer(state, block):
    state.validators[int(block.message.proposer_index)].slashed = True


def _deposit_count(state, block):
    state.eth1_data.deposit_count = int(state.eth1_deposit_index) + 1


def _state_root(state, block):
    root = bytearray(bytes(block.message.state_root))
    root[0] ^= 1
    block.message.state_root = bytes(root)


def _overflow(state, block):
    state.balances[int(block.message.proposer_index)] = 2 ** 64 - 1


#: case: (the change, the class raised, the start of its message).
INVALID = {
    "wrong_slot": (_wrong_slot, "BlockProcessingError", "block slot"),
    "wrong_proposer": (_wrong_proposer, "BlockProcessingError", "wrong proposer"),
    "bad_parent_root": (_bad_parent, "BlockProcessingError", "parent root mismatch"),
    "slashed_proposer": (_slashed_proposer, "BlockProcessingError", "proposer is slashed"),
    "wrong_deposit_count": (_deposit_count, "BlockProcessingError", "expected 1 deposits"),
    "wrong_state_root": (_state_root, "StateRootMismatch", "state root mismatch"),
    "arithmetic_overflow": (_overflow, "BlockProcessingError", "arithmetic out of u64 range"),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_block_raises_as_jax(chains, case):
    """The same broken block (deneb, slot 10, after the upgrade) on the same
    state, advanced to the block's slot (one past it for the wrong slot)
    and then changed, raises the same error class with the same message in
    both packages."""
    mutate, cls, message = INVALID[case]
    j_state, signed, j_types, j_spec, p_types, p_spec = _pre(chains, BLOCKS - 1)
    target = int(signed.message.slot) + (case == "wrong_slot")
    p_state = process_slots(to_port(j_state, p_types), target, p_types, p_spec)
    j_state = j_process_slots(j_state, target, j_types, j_spec)
    p_signed, j_signed = port_block(signed, p_types), copy.deepcopy(signed)
    mutate(j_state, j_signed)
    mutate(p_state, p_signed)
    ours = raised(lambda: state_transition(p_state, p_signed, p_types, p_spec))
    theirs = raised(lambda: j_transition(j_state, j_signed, j_types, j_spec))
    assert ours == theirs
    assert ours[0] == cls and ours[1].startswith(message), ours


# ------------------------------------------------------ real signatures


@pytest.fixture(scope="module")
def real_block():
    """(JAX pre-state at slot 1, the signed block of slot 2, the JAX chain's
    post-state, JAX types): 8 validators with real keys, the block carrying
    a proposal, a randao reveal, an attestation and a sync aggregate; the
    JAX package's chain imported both blocks on its host backend."""
    j_spec = j_minimal_spec()
    with jax_backend("host"):
        harness = BeaconChainHarness(validator_count=8, spec=j_spec, fake_crypto=False,
                                     genesis_time=GENESIS_TIME)
        harness.extend_chain(1, attest=True)
        pre = harness.chain.head_state.copy()
        harness.advance_slot()
        signed = harness.produce_signed_block()
        root = harness.chain.process_block(signed)
    return pre, signed, harness.chain.get_state(root), harness.types


def _swapped(signed):
    """``signed`` with its attestation's signature swapped for the sync
    aggregate's."""
    out = copy.deepcopy(signed)
    body = out.message.body
    body.attestations[0].signature = bytes(body.sync_aggregate.sync_committee_signature)
    return out


def test_real_crypto_block_verifies_on_the_cpu_as_jax(real_block):
    """``VERIFY_BULK`` through the ``"torch"`` backend on the CPU accepts
    the block in one batch of four sets, with the JAX chain's post-state."""
    pre, signed, j_post, _ = real_block
    p_spec = minimal_spec()
    p_types = build_types(p_spec.preset)
    pbackends.set_backend("torch")
    torch_backend.configure(device="cpu")
    port = to_port(pre, p_types)
    p_signed = port_block(signed, p_types)
    verifier = pb.BlockSignatureVerifier(process_slots(port.copy(), 2, p_types, p_spec),
                                         p_types, p_spec)
    verifier.include_all_signatures(p_signed)
    assert [len(s.signing_keys) for s in verifier.sets][:3] == [1, 1, 1]
    assert len(verifier.sets) == 4
    out = state_transition(port, p_signed, p_types, p_spec)
    assert out.as_ssz_bytes() == j_post.as_ssz_bytes()


def test_swapped_signature_is_refused_by_both(real_block):
    pre, signed, _, j_types = real_block
    j_spec, p_spec = specs({})
    p_types = build_types(p_spec.preset)
    pbackends.set_backend("torch")
    torch_backend.configure(device="cpu")
    bad = _swapped(signed)
    with jax_backend("host"):
        theirs = raised(lambda: j_transition(pre.copy(), bad, j_types, j_spec))
    ours = raised(lambda: state_transition(to_port(pre, p_types), port_block(bad, p_types),
                                              p_types, p_spec))
    assert ours == theirs == ("BlockProcessingError", "bulk signature verification failed")


def test_block_verify_defaults_to_the_card(real_block):
    """Block processing verifies on the card unless told otherwise: the
    selector's default backend on its default device raises where there is
    no card, before the state changes."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    pre, signed, _, _ = real_block
    p_spec = minimal_spec()
    p_types = build_types(p_spec.preset)
    pbackends._ACTIVE = pbackends._NAME = None
    torch_backend.reset_for_tests()
    state = process_slots(to_port(pre, p_types), 2, p_types, p_spec)
    before = state.as_ssz_bytes()
    with pytest.raises(RuntimeError, match="is_available"):
        pb.per_block_processing(state, port_block(signed, p_types), p_types, p_spec)
    assert pbackends.backend_name() == "torch"
    assert state.as_ssz_bytes() == before


# ------------------------------------------------------------- genesis


@pytest.mark.parametrize("fork", sorted(GENESIS_FORKS))
def test_interop_genesis_matches_jax(fork):
    j_spec, p_spec = specs(GENESIS_FORKS[fork])
    ref = jgenesis.interop_genesis_state(VALIDATORS, j_build_types(j_spec.preset), j_spec,
                                         genesis_time=GENESIS_TIME)
    ours = genesis.interop_genesis_state(VALIDATORS, build_types(p_spec.preset), p_spec,
                                         genesis_time=GENESIS_TIME)
    assert fork_of(ours) == fork
    assert ours.as_ssz_bytes() == ref.as_ssz_bytes()
    assert ours.hash_tree_root() == ref.hash_tree_root()


def test_interop_keypairs_match_jax():
    for i in range(VALIDATORS):
        ours_sk, ours_pk = genesis.interop_keypair(i)
        theirs_sk, theirs_pk = jgenesis.interop_keypair(i)
        assert ours_sk.scalar == theirs_sk.scalar
        assert bytes(ours_pk) == bytes(theirs_pk)


def test_interop_keypairs_match_published_vectors():
    """The in-repo vectors of the published interop keypairs
    (``tests/vectors/interop_keypairs.json``)."""
    with open(os.path.join(VECTORS, "interop_keypairs.json")) as f:
        pairs = json.load(f)["pairs"]
    for i, pair in enumerate(pairs):
        sk, pk = genesis.interop_keypair(i)
        assert sk.scalar == int(pair["privkey"], 16)
        assert bytes(pk).hex() == pair["pubkey"][2:]


@pytest.mark.parametrize("signature", ["valid", "foreign"])
def test_apply_deposit_matches_jax(signature):
    """A new validator's deposit from the in-repo staking-deposit-cli
    vectors (``tests/vectors/deposit_data.json``, signed by an independent
    implementation over their network's fork version): with its own
    signature it joins the registry, with another deposit's it is skipped;
    the port's state equals the JAX package's either way."""
    with open(os.path.join(VECTORS, "deposit_data.json")) as f:
        cases = json.load(f)["cases"]
    vector = cases[0]
    overrides = dict(genesis_fork_version=bytes.fromhex(vector["fork_version"]))
    j_spec, p_spec = specs(overrides)
    j_types = j_build_types(j_spec.preset)
    p_types = build_types(p_spec.preset)
    ref = jgenesis.interop_genesis_state(8, j_types, j_spec, genesis_time=GENESIS_TIME)
    port = to_port(ref, p_types)
    sig = vector["signature"] if signature == "valid" else cases[1]["signature"]

    def deposit(types):
        data = types.DepositData(
            pubkey=bytes.fromhex(vector["pubkey"]),
            withdrawal_credentials=bytes.fromhex(vector["withdrawal_credentials"]),
            amount=vector["amount"], signature=bytes.fromhex(sig))
        return types.Deposit(proof=[bytes(32)] * 33, data=data)

    with jax_backend("host"):
        jpb.apply_deposit(ref, deposit(j_types), j_types, j_spec, verify_proof=False)
    pbackends.set_backend("host")
    pb.apply_deposit(port, deposit(p_types), p_types, p_spec, verify_proof=False)
    assert port.as_ssz_bytes() == ref.as_ssz_bytes()
    assert len(port.validators) == (9 if signature == "valid" else 8)


# ------------------------------------------------------ compare_fields


def test_compare_fields_names_the_same_leaves(chains):
    """Two states that differ in the slot, one balance and one validator
    field: the port names the same leaves, in the same order and words, as
    the JAX package, and ``assert_states_equal`` fails with them."""
    ref, _, _ = chains["capella-deneb"]
    _, p_spec = specs(SCHEDULES["capella-deneb"])
    p_types = build_types(p_spec.preset)

    def diverge(state):
        other = state.copy()
        other.slot = int(state.slot) + 5
        other.balances[3] = int(state.balances[3]) - 7
        other.validators[5].slashed = True
        return other

    port = to_port(ref, p_types)
    theirs = jcf.compare_fields(ref, diverge(ref))
    ours = cf.compare_fields(port, diverge(port))
    assert ours == theirs and len(ours) == 3
    assert cf.compare_fields(port, port.copy()) == []
    with pytest.raises(AssertionError) as info:
        cf.assert_states_equal(port, diverge(port))
    assert all(line in str(info.value) for line in ours)


# ------------------------------------------------- the [block] workload


@pytest.fixture(scope="module")
def small_case():
    return workload.block_import_case(1024, seed=5)


def test_block_import_case_imports_on_the_cpu(small_case, monkeypatch):
    """The chip script's block at 1,024 validators (mainnet preset): every
    operation the 2^20 block carries; ``VERIFY_BULK`` through the
    ``"torch"`` backend on the CPU as one batch of every set, to the host
    run's state; the state root is the block's."""
    case = small_case
    pbackends.set_backend("torch")
    torch_backend.configure(device="cpu")
    assert workload.warm_pubkey_cache(case.keys) == len(case.keys.points)
    body = case.signed_block.message.body
    assert (len(body.attestations), len(body.proposer_slashings), len(body.attester_slashings),
            len(body.voluntary_exits), len(body.bls_to_execution_changes), len(body.deposits),
            len(body.execution_payload.withdrawals), len(body.blob_kzg_commitments)) == \
        (2, 1, 1, 1, 1, 0, 16, 6)
    pre = case.pre_state.copy()
    batches = []
    real_verify = pb.bls.verify_signature_sets

    def counting(sets, *a, **kw):
        batches.append(len(sets))
        return real_verify(sets, *a, **kw)

    monkeypatch.setattr(pb.bls, "verify_signature_sets", counting)
    post = state_transition(pre, case.signed_block, case.types, case.spec)
    assert batches == [2 + 9]
    assert post.as_ssz_bytes() == case.host_state.as_ssz_bytes()
    assert post.hash_tree_root() == bytes(case.signed_block.message.state_root)


def test_clone_state_is_a_deep_copy(small_case):
    """``workload.clone_state`` (the chip script's copy of a 2^20 state):
    the same bytes and root as the state, its caches carried over, and no
    container or list shared with it."""
    state = small_case.host_state
    root = state.hash_tree_root()
    clone = workload.clone_state(state)
    assert clone.as_ssz_bytes() == state.as_ssz_bytes()
    assert clone._thc is not state._thc and clone._cc is not state._cc
    clone.validators[0].slashed = not state.validators[0].slashed
    clone.balances[1] += 1
    clone.current_epoch_participation[2] ^= 1
    clone.latest_block_header.slot += 1
    clone.eth1_data_votes[0].deposit_count += 1
    assert state.hash_tree_root() == root
    assert clone.hash_tree_root() == copy.deepcopy(clone).hash_tree_root() != root


def test_block_import_case_refusals(small_case):
    """A swapped attestation signature (the block re-signed) fails the bulk
    verify; a state root off by one byte (re-signed) raises
    ``StateRootMismatch``."""
    case = small_case
    pbackends.set_backend("torch")
    torch_backend.configure(device="cpu")
    workload.warm_pubkey_cache(case.keys)
    message = copy.deepcopy(case.signed_block.message)
    atts = message.body.attestations
    atts[0].signature, atts[1].signature = bytes(atts[1].signature), bytes(atts[0].signature)
    with pytest.raises(pb.BlockProcessingError, match="bulk signature verification failed"):
        state_transition(case.pre_state.copy(), workload.resign(case, message),
                            case.types, case.spec)
    message = copy.deepcopy(case.signed_block.message)
    root = bytearray(bytes(message.state_root))
    root[-1] ^= 0xFF
    message.state_root = bytes(root)
    with pytest.raises(StateRootMismatch):
        state_transition(case.pre_state.copy(), workload.resign(case, message),
                            case.types, case.spec)
    signature_sets._PUBKEY_CACHE.clear()
