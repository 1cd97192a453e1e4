"""The port's fork choice vs the JAX package's.

``lighthouse_tpu_torch.fork_choice`` copies the JAX package's proto-array,
its spec wrapper and its persistence.  Every comparison is exact:

- the scripted proto-array and wrapper scenarios of
  ``tests/test_fork_choice.py`` run once on each package (the module's
  names re-pointed at the port for the port's run); every proto-array and
  fork choice a scenario builds ends with the same nodes, weights, best
  links, votes and checkpoints as in the JAX package's run, and every
  unrealized-checkpoint pair it computes is the same;
- a ``ForkChoice`` anchored at a harness chain's genesis (minimal preset,
  64 validators, fake crypto) takes the chain's blocks and their
  attestations, a fork included: the port's head and node weights equal
  the JAX package's after every block, and so do the persisted bytes
  (``fork_choice_to_bytes``) at the end;
- ``restore_fork_choice`` round-trips those bytes and gives the same head.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import test_fork_choice as tfc  # noqa: E402
from lighthouse_tpu.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu.consensus import helpers as jh  # noqa: E402
from lighthouse_tpu.crypto.bls import backends as jbackends  # noqa: E402
from lighthouse_tpu.fork_choice import ForkChoice as JForkChoice  # noqa: E402
from lighthouse_tpu.fork_choice import persistence as jpersist  # noqa: E402
from lighthouse_tpu.types.spec import minimal_spec as j_minimal_spec  # noqa: E402
from lighthouse_tpu_torch import fork_choice as pfc  # noqa: E402
from lighthouse_tpu_torch.consensus import genesis as pgenesis  # noqa: E402
from lighthouse_tpu_torch.consensus import helpers as h  # noqa: E402
from lighthouse_tpu_torch.fork_choice import persistence  # noqa: E402
from lighthouse_tpu_torch.ops import tree_hash as th  # noqa: E402
from lighthouse_tpu_torch.types.containers import build_types  # noqa: E402
from lighthouse_tpu_torch.types.spec import minimal_spec  # noqa: E402
from test_torch_types import to_port  # noqa: E402

VALIDATORS = 64
GENESIS_TIME = 1_600_000_000

#: The names ``tests/test_fork_choice.py`` reads from the JAX package, and
#: the port's objects that stand in for them in the port's run.
PORT_NAMES = {
    "ExecutionStatus": pfc.ExecutionStatus,
    "ForkChoice": pfc.ForkChoice,
    "InvalidBlock": pfc.InvalidBlock,
    "ProtoArray": pfc.ProtoArray,
    "ProtoArrayError": pfc.ProtoArrayError,
    "VoteTracker": pfc.VoteTracker,
    "compute_unrealized_checkpoints": pfc.compute_unrealized_checkpoints,
    "interop_genesis_state": pgenesis.interop_genesis_state,
    "build_types": build_types,
    "minimal_spec": minimal_spec,
}
SCENARIO_CLASSES = ("TestProtoArrayVotes", "TestProtoArrayFFG", "TestExecutionStatus",
                    "TestPrune", "TestForkChoiceWrapper")
SCENARIOS = [f"{cls}.{name}" for cls in SCENARIO_CLASSES
             for name in sorted(vars(getattr(tfc, cls))) if name.startswith("test_")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _host_hash():
    """The host tree-hash engine (fork choice hashes its anchor state), as
    the JAX package's tests run; the default comes back afterwards."""
    th.configure(enabled=False)
    yield
    th.reset_for_tests()


def _proto_summary(pa) -> tuple:
    return ([dataclasses.astuple(n) for n in pa.nodes], dict(pa.indices),
            dict(pa._root_ids), pa._id_to_node.tolist(), pa.justified_checkpoint,
            pa.finalized_checkpoint, pa.previous_proposer_boost)


def _fc_summary(fc) -> tuple:
    votes = fc.votes
    return (_proto_summary(fc.proto), fc.current_slot, fc.justified_checkpoint,
            fc.finalized_checkpoint, fc.unrealized_justified_checkpoint,
            fc.unrealized_finalized_checkpoint, fc.proposer_boost_root,
            [(q.slot, q.attesting_indices.tolist(), q.block_root, q.target_epoch)
             for q in fc.queued_attestations],
            votes.current_root_id.tolist(), votes.next_root_id.tolist(),
            votes.next_epoch.tolist(), votes.equivocating.tolist(),
            fc._old_balances.tolist(), np.asarray(fc.justified_balances).tolist())


def run_scenario(scenario: str, port: bool, monkeypatch) -> list:
    """Run one scenario of ``tests/test_fork_choice.py`` (on the port's
    objects when ``port``); the end state of every proto-array and fork
    choice it built and every unrealized-checkpoint pair it computed, in
    order."""
    with monkeypatch.context() as m:
        if port:
            for name, obj in PORT_NAMES.items():
                m.setattr(tfc, name, obj)
        built = []

        class Proto(tfc.ProtoArray):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                built.append(self)

        class Choice(tfc.ForkChoice):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                built.append(self)

        unrealized = tfc.compute_unrealized_checkpoints

        def checkpoints(*a, **kw):
            out = unrealized(*a, **kw)
            built.append(out)
            return out

        m.setattr(tfc, "ProtoArray", Proto)
        m.setattr(tfc, "ForkChoice", Choice)
        m.setattr(tfc, "compute_unrealized_checkpoints", checkpoints)
        cls, name = scenario.split(".")
        kwargs = {}
        if cls == "TestForkChoiceWrapper":
            spec = tfc.minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                                    capella_fork_epoch=0, deneb_fork_epoch=None)
            kwargs = {"spec": spec, "types": tfc.build_types(spec.preset)}
        getattr(getattr(tfc, cls)(), name)(**kwargs)
    return [_fc_summary(x) if isinstance(x, Choice)
            else _proto_summary(x) if isinstance(x, Proto) else x for x in built]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scripted_scenario_matches_jax(scenario, monkeypatch):
    ours = run_scenario(scenario, True, monkeypatch)
    theirs = run_scenario(scenario, False, monkeypatch)
    assert ours == theirs
    assert ours, "the scenario built nothing to compare"


# ------------------------------------------------------------ a chain


@pytest.fixture(scope="module")
def chain():
    """(JAX genesis block root and state, [(signed block, its root, its JAX
    post-state)] in import order, JAX spec and types): a deneb harness chain of four
    epochs and two, every slot attested, and one block on a fork from three
    slots back."""
    j_spec = j_minimal_spec()
    prev = jbackends.backend_name()
    try:
        harness = BeaconChainHarness(validator_count=VALIDATORS, spec=j_spec, fake_crypto=True,
                                     genesis_time=GENESIS_TIME)
        roots = harness.extend_chain(4 * j_spec.slots_per_epoch, attest=True)
        harness.advance_slot()
        fork = harness.produce_signed_block(parent_root=roots[-3])
        roots.append(harness.chain.process_block(fork, block_delay_seconds=1.0))
        roots += harness.extend_chain(2, attest=True)
    finally:
        jbackends.set_backend(prev)
    c = harness.chain
    blocks = [(c.get_block(r), r, c.get_state(r)) for r in roots]
    return c.genesis_block_root, c.genesis_state, blocks, j_spec, harness.types


def _replay(fc, blocks, indexed_of, heads):
    """Feed ``blocks`` to ``fc`` as block import does (the block, then its
    attestations), recording (head, weights) after each."""
    for signed, root, state in blocks:
        block = signed.message
        slot = int(block.slot)
        fc.on_block(current_slot=slot, block=block, block_root=root, state=state,
                    block_delay_seconds=1.0)
        for att in block.body.attestations:
            fc.on_attestation(
                current_slot=slot, attestation_slot=int(att.data.slot),
                attesting_indices=list(indexed_of(state, att)),
                beacon_block_root=bytes(att.data.beacon_block_root),
                target_epoch=int(att.data.target.epoch), target_root=bytes(att.data.target.root),
                is_from_block=True)
        heads.append((fc.get_head(slot), [int(n.weight) for n in fc.proto.nodes]))


@pytest.fixture(scope="module")
def replayed(chain):
    """Both packages' fork choice fed the chain: (JAX fc, port fc, JAX
    heads, port heads, port genesis state, port spec)."""
    groot, genesis, blocks, j_spec, j_types = chain
    p_spec = minimal_spec()
    p_types = build_types(p_spec.preset)
    th.configure(enabled=False)
    p_genesis = to_port(genesis, p_types)
    p_blocks = [(p_types.signed_block[type(b.message).fork_name].from_ssz_bytes(b.as_ssz_bytes()),
                 r, to_port(s, p_types)) for b, r, s in blocks]
    j_states = {r: s for _, r, s in blocks}
    p_states = {r: s for _, r, s in p_blocks}
    j_states[groot], p_states[groot] = genesis, p_genesis

    j_fc = JForkChoice(spec=j_spec, genesis_block_root=groot, genesis_state=genesis)
    j_fc.set_justified_state_provider(j_states.get)
    p_fc = pfc.ForkChoice(spec=p_spec, genesis_block_root=groot, genesis_state=p_genesis)
    p_fc.set_justified_state_provider(p_states.get)
    j_heads, p_heads = [], []
    _replay(j_fc, blocks,
            lambda s, a: jh.get_indexed_attestation(s, a, j_types, j_spec).attesting_indices,
            j_heads)
    _replay(p_fc, p_blocks,
            lambda s, a: h.get_indexed_attestation(s, a, p_types, p_spec).attesting_indices,
            p_heads)
    th.reset_for_tests()
    return j_fc, p_fc, j_heads, p_heads, p_genesis, p_spec


def test_chain_heads_and_weights_match_jax(replayed, chain):
    j_fc, p_fc, j_heads, p_heads, _, _ = replayed
    assert p_heads == j_heads
    assert len({head for head, _ in p_heads}) > 30
    assert p_fc.justified_checkpoint == j_fc.justified_checkpoint
    assert p_fc.finalized_checkpoint == j_fc.finalized_checkpoint
    assert p_fc.finalized_checkpoint[0] >= 2, "the chain finalizes"
    blocks = chain[2]
    fork_root = blocks[-3][1]
    assert p_heads[-1][0] != fork_root and p_fc.contains_block(fork_root)
    assert persistence.fork_choice_to_bytes(p_fc) == jpersist.fork_choice_to_bytes(j_fc)


def test_restore_round_trips(replayed, chain):
    """The persisted bytes restore into a freshly anchored fork choice of
    the port, which persists to the same bytes and finds the same head."""
    _, p_fc, _, p_heads, p_genesis, p_spec = replayed
    groot = chain[0]
    raw = persistence.fork_choice_to_bytes(p_fc)
    fresh = pfc.ForkChoice(spec=p_spec, genesis_block_root=groot, genesis_state=p_genesis)
    persistence.restore_fork_choice(fresh, raw)
    assert persistence.fork_choice_to_bytes(fresh) == raw
    slot = int(chain[2][-1][0].message.slot)
    assert fresh.get_head(slot) == p_fc.get_head(slot) == p_heads[-1][0]
