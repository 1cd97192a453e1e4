"""The port's consensus layer vs the JAX package's.

``lighthouse_tpu_torch.consensus`` copies the JAX package's helpers,
shuffle, signature sets, slot and epoch processing and fork upgrades.
States cross from the JAX package by their SSZ bytes
(``test_torch_types.to_port``); chains are the JAX package's
``BeaconChainHarness`` (minimal preset, fake crypto, 64 validators),
stopped one slot before an epoch boundary.  Every comparison is exact:

- shuffles, shuffled indices, seeds, committees, proposers, the next sync
  committee and the registry accessors equal the JAX package's on the
  same states;
- ``per_slot.process_slots`` across a boundary on the numpy backend gives
  the JAX package's SSZ bytes, phase0 through deneb, with and without an
  inactivity leak, across a sync-committee period and across fork
  upgrades;
- the epoch path defaults to the card and raises where there is none,
  before the state changes; an electra state is refused.

The device programs of the epoch boundary are held against the JAX
package in ``tests/test_torch_epoch.py``.
"""

import copy
import hashlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu.consensus import helpers as jh  # noqa: E402
from lighthouse_tpu.consensus import per_epoch as jpe  # noqa: E402
from lighthouse_tpu.consensus import safe_arith as jsa  # noqa: E402
from lighthouse_tpu.consensus import shuffling as jshuffling  # noqa: E402
from lighthouse_tpu.consensus.genesis import interop_genesis_state  # noqa: E402
from lighthouse_tpu.consensus.per_slot import process_slots as j_process_slots  # noqa: E402
from lighthouse_tpu.crypto.bls import backends as jbackends  # noqa: E402
from lighthouse_tpu.types.containers import build_types as j_build_types  # noqa: E402
from lighthouse_tpu.types.spec import minimal_spec as j_minimal_spec  # noqa: E402
from lighthouse_tpu_torch.consensus import helpers as h  # noqa: E402
from lighthouse_tpu_torch.consensus import per_epoch as pe  # noqa: E402
from lighthouse_tpu_torch.consensus import per_slot  # noqa: E402
from lighthouse_tpu_torch.consensus import safe_arith as sa  # noqa: E402
from lighthouse_tpu_torch.consensus import shuffling  # noqa: E402
from lighthouse_tpu_torch.ops import tree_hash as th  # noqa: E402
from lighthouse_tpu_torch.types.containers import build_types  # noqa: E402
from lighthouse_tpu_torch.types.spec import (  # noqa: E402
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_SYNC_COMMITTEE,
    minimal_spec,
)
from test_torch_types import to_port  # noqa: E402

VALIDATORS = 64

#: Fork schedules of the minimal preset whose genesis fork is the key.
FORKS = {
    "phase0": dict(altair_fork_epoch=None, bellatrix_fork_epoch=None,
                   capella_fork_epoch=None, deneb_fork_epoch=None),
    "altair": dict(bellatrix_fork_epoch=None, capella_fork_epoch=None,
                   deneb_fork_epoch=None),
    "bellatrix": dict(capella_fork_epoch=None, deneb_fork_epoch=None),
    "capella": dict(deneb_fork_epoch=None),
    "deneb": {},
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
    """The host tree-hash engine and the numpy epoch backend, as the JAX
    package's tests run; the defaults (the card) come back afterwards."""
    th.configure(enabled=False)
    pe.configure(backend="numpy")
    yield
    pe.reset_for_tests()
    th.reset_for_tests()


def specs(fork):
    return j_minimal_spec(**FORKS[fork]), minimal_spec(**FORKS[fork])


def chain_state(fork, epochs=7):
    """The JAX harness's head state ``epochs`` epochs in, one slot before
    the next boundary, every slot attested; and the harness's types."""
    j_spec, _ = specs(fork)
    prev = jbackends.backend_name()
    try:
        harness = BeaconChainHarness(validator_count=VALIDATORS, spec=j_spec, fake_crypto=True)
        harness.extend_chain(j_spec.slots_per_epoch * epochs - 1, attest=True)
    finally:
        jbackends.set_backend(prev)
    return fresh(harness.head_state), harness.types


def fresh(state):
    out = copy.deepcopy(state)
    out._cc = {}
    return out


def leaking(state, types):
    """A copy of ``state`` whose checkpoints are at genesis (no finality for
    epochs: the boundary's transition runs in an inactivity leak)."""
    out = fresh(state)
    genesis = types.Checkpoint(epoch=0, root=bytes(32))
    out.finalized_checkpoint = genesis
    out.previous_justified_checkpoint = genesis
    out.current_justified_checkpoint = genesis
    out.justification_bits = [False] * len(out.justification_bits)
    return out


@pytest.fixture(scope="module")
def chains():
    """{fork: (JAX state one slot before a boundary, JAX types)}, built
    once."""
    return {fork: chain_state(fork) for fork in FORKS}


def boundary_pair(chains, fork, leak):
    """(a copy of the JAX state, its port copy, the boundary slot, JAX
    spec, port spec, port types)."""
    ref, j_types = chains[fork]
    ref = leaking(ref, j_types) if leak else fresh(ref)
    j_spec, p_spec = specs(fork)
    p_types = build_types(p_spec.preset)
    target = int(ref.slot) + 1
    assert target % p_spec.slots_per_epoch == 0
    return ref, to_port(ref, p_types), target, j_spec, p_spec, p_types


# ------------------------------------------------------------- the shuffle


SEED = hashlib.sha256(b"port-consensus-shuffle").digest()


@pytest.mark.parametrize("n", [0, 1, 2, 5, 63, 64, 65, 255, 256, 257, 1000])
def test_shuffle_list_and_index_match_jax(n):
    values = np.random.default_rng(n).permutation(n).astype(np.int64)
    for rounds in (10, 90):
        ours = shuffling.shuffle_list(values, SEED, rounds)
        assert np.array_equal(ours, jshuffling.shuffle_list(values, SEED, rounds))
        for i in range(0, n, max(1, n // 16)):
            j = shuffling.compute_shuffled_index(i, n, SEED, rounds)
            assert j == jshuffling.compute_shuffled_index(i, n, SEED, rounds)
            assert ours[i] == values[j]


@pytest.mark.parametrize("n", [1, 255, 256, 257])
def test_round_digest_table_matches_jax(n):
    chunks = (n + 255) // 256
    ours = shuffling.round_digest_table(SEED, 10, chunks, n)
    theirs = jshuffling.round_digest_table(SEED, 10, chunks, n)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)


def test_safe_arith_matches_jax():
    big = 2 ** 64 - 1
    for op in ("safe_add", "safe_sub", "safe_mul", "safe_div", "safe_mod"):
        for a, b in ((7, 3), (big, 0), (big, 1), (0, 5), (2 ** 32, 2 ** 32)):
            results = []
            for mod in (sa, jsa):
                try:
                    results.append(getattr(mod, op)(a, b))
                except mod.ArithError:
                    results.append("ArithError")
            assert results[0] == results[1], (op, a, b)
    assert sa.saturating_sub(3, 5) == jsa.saturating_sub(3, 5) == 0


# ----------------------------------------------------------------- duties


@pytest.mark.parametrize("fork", sorted(FORKS))
def test_duties_match_jax(chains, fork):
    """Seeds, active sets, committees, proposers, churn and (altair+) the
    next sync committee's indices on a harness state."""
    ref = fresh(chains[fork][0])
    j_spec, p_spec = specs(fork)
    port = to_port(ref, build_types(p_spec.preset))
    cur = h.get_current_epoch(port, p_spec)
    assert cur == jh.get_current_epoch(ref, j_spec)
    for epoch in (cur - 1, cur, cur + 1):
        for domain in (DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER, DOMAIN_SYNC_COMMITTEE):
            assert h.get_seed(port, epoch, domain, p_spec) == jh.get_seed(ref, epoch, domain, j_spec)
        assert np.array_equal(h.get_active_validator_indices(port, epoch),
                              jh.get_active_validator_indices(ref, epoch))
        spe = p_spec.slots_per_epoch
        count = h.get_committee_count_per_slot(port, epoch, p_spec)
        assert count == jh.get_committee_count_per_slot(ref, epoch, j_spec)
        for slot in range(epoch * spe, (epoch + 1) * spe):
            for index in range(count):
                assert np.array_equal(h.get_beacon_committee(port, slot, index, p_spec),
                                      jh.get_beacon_committee(ref, slot, index, j_spec))
    spe = p_spec.slots_per_epoch
    for slot in range(cur * spe, (cur + 1) * spe):
        assert h.get_beacon_proposer_index(port, p_spec, slot) == \
            jh.get_beacon_proposer_index(ref, j_spec, slot)
    assert h.get_total_active_balance(port, p_spec) == jh.get_total_active_balance(ref, j_spec)
    assert h.get_validator_churn_limit(port, p_spec) == jh.get_validator_churn_limit(ref, j_spec)
    if fork != "phase0":
        assert h.get_next_sync_committee_indices(port, p_spec) == \
            jh.get_next_sync_committee_indices(ref, j_spec)


# ------------------------------------------------- whole epoch, numpy backend


@pytest.mark.parametrize("leak", [False, True], ids=["no_leak", "leak"])
@pytest.mark.parametrize("fork", sorted(FORKS))
def test_process_slots_across_a_boundary_matches_jax(chains, fork, leak):
    """``process_slots`` over an epoch boundary on the numpy backend: the
    port's state is the JAX package's, byte for byte."""
    ref, port, target, j_spec, p_spec, p_types = boundary_pair(chains, fork, leak)
    assert jpe.is_in_inactivity_leak(ref, j_spec) is leak
    j_out = j_process_slots(ref, target, chains[fork][1], j_spec)
    p_out = per_slot.process_slots(port, target, p_types, p_spec)
    assert type(p_out).fork_name == fork
    assert p_out.as_ssz_bytes() == j_out.as_ssz_bytes()
    assert p_out.hash_tree_root() == j_out.hash_tree_root()


def test_sync_committee_period_crossing_matches_jax():
    """An interop genesis state (real BLS keys) carried through the first
    sync-committee period: the rotation aggregates the next committee's
    keys through the port's BLS API, to the JAX package's bytes."""
    j_spec, p_spec = specs("altair")
    j_types = j_build_types(j_spec.preset)
    ref = interop_genesis_state(VALIDATORS, j_types, j_spec, genesis_time=1_600_000_000)
    p_types = build_types(p_spec.preset)
    port = to_port(ref, p_types)
    target = p_spec.preset.epochs_per_sync_committee_period * p_spec.slots_per_epoch
    next_before = port.next_sync_committee.as_ssz_bytes()
    j_out = j_process_slots(ref, target, j_types, j_spec)
    p_out = per_slot.process_slots(port, target, p_types, p_spec)
    assert p_out.current_sync_committee.as_ssz_bytes() == next_before
    assert p_out.next_sync_committee.as_ssz_bytes() != next_before
    assert p_out.as_ssz_bytes() == j_out.as_ssz_bytes()


def test_fork_upgrades_match_jax():
    """process_slots from a phase0 genesis through altair, bellatrix,
    capella and deneb, one fork an epoch (upgrades.py)."""
    overrides = dict(altair_fork_epoch=1, bellatrix_fork_epoch=2, capella_fork_epoch=3,
                     deneb_fork_epoch=4)
    j_spec, p_spec = j_minimal_spec(**overrides), minimal_spec(**overrides)
    j_types = j_build_types(j_spec.preset)
    p_types = build_types(p_spec.preset)
    ref = interop_genesis_state(VALIDATORS, j_types, j_spec, genesis_time=1_600_000_000)
    port = to_port(ref, p_types)
    assert type(port).fork_name == "phase0"
    spe = p_spec.slots_per_epoch
    for epoch, fork in ((1, "altair"), (2, "bellatrix"), (3, "capella"), (4, "deneb")):
        ref = j_process_slots(ref, epoch * spe, j_types, j_spec)
        port = per_slot.process_slots(port, epoch * spe, p_types, p_spec)
        assert type(port).fork_name == type(ref).fork_name == fork
        assert port.as_ssz_bytes() == ref.as_ssz_bytes()


# --------------------------------------------------------- what is refused


def test_epoch_path_defaults_to_the_card(chains):
    """The port's epoch path runs on the card unless configured otherwise;
    without a card it raises before the state changes."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    pe.reset_for_tests()
    assert (pe._EPOCH_BACKEND, pe._FUSED_BOUNDARY, pe._DEVICE) == ("device", True, "cuda")
    _, port, _, _, p_spec, p_types = boundary_pair(chains, "deneb", False)
    before = port.as_ssz_bytes()
    with pytest.raises(RuntimeError, match="is_available"):
        pe.process_epoch(port, p_types, p_spec)
    assert port.as_ssz_bytes() == before


def test_electra_epoch_is_refused():
    p_spec = minimal_spec(electra_fork_epoch=0)
    p_types = build_types(p_spec.preset)
    state = p_types.state["electra"]()
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        pe.process_epoch(state, p_types, p_spec)
