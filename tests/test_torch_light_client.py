"""The port's ``light_client/`` (the verifying light-client store and the
client that syncs over RPC) vs the JAX package's.

- The JAX package's ``test_light_client.py`` re-pointed at the port, but
  for ``test_lc_http_routes``, which ``test_torch_http_api.py`` already
  carries: branches against the state root, updates produced at import,
  the store following the chain across a sync-committee period, the
  refusals (a tampered branch, a tampered execution root), the Electra
  era, the SSZ and JSON round trips, and the client syncing over the
  light-client req/resp protocols;
- parity: one harness schedule in both packages (same spec, same
  graffiti): the bootstraps and updates are equal byte for byte, both
  stores fed the other package's objects (by their SSZ bytes) end with
  equal headers and committees, and both refuse the same tampered inputs
  with the same message.

Chains run on the port's CPU routes (host tree hashing, the numpy epoch
backend) with fake crypto: the sync aggregates verify through the
``"fake"`` backend here; on a node they go to the card.
"""

import dataclasses

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu.chain import BeaconChainHarness as JHarness  # noqa: E402
from lighthouse_tpu.chain.graffiti_calculator import GraffitiOrigin as JGraffitiOrigin  # noqa: E402
from lighthouse_tpu.light_client import LightClientError as JLightClientError  # noqa: E402
from lighthouse_tpu.light_client import LightClientStore as JLightClientStore  # noqa: E402
from lighthouse_tpu.types.spec import MINIMAL_PRESET as J_MINIMAL_PRESET  # noqa: E402
from lighthouse_tpu.types.spec import minimal_spec as j_minimal_spec  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.chain.graffiti_calculator import GraffitiOrigin  # noqa: E402
from lighthouse_tpu_torch.chain.light_client import (  # noqa: E402
    FINALITY_BRANCH_DEPTH,
    SYNC_COMMITTEE_BRANCH_DEPTH,
    finality_branch,
    sync_committee_branch,
)
from lighthouse_tpu_torch.consensus.per_block import is_valid_merkle_branch  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.light_client import LightClientError, LightClientStore  # noqa: E402
from lighthouse_tpu_torch.types.spec import MINIMAL_PRESET, minimal_spec  # noqa: E402
from test_torch_chain import GRAFFITI, jax_backend, port_cpu  # noqa: E402,F401

#: The harness schedule: capella from genesis, sync periods of two epochs
#: (the minimal default of 8 would need 64 slots a period).
SCHEDULE = dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
                deneb_fork_epoch=None)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def lc_spec(**overrides):
    preset = dataclasses.replace(MINIMAL_PRESET, epochs_per_sync_committee_period=2)
    return minimal_spec(preset=preset, **{**SCHEDULE, **overrides})


@pytest.fixture()
def harness():
    set_backend("fake")
    return BeaconChainHarness(validator_count=16, spec=lc_spec(), fake_crypto=True)


def test_branches_verify_against_state_root(harness):
    state = harness.chain.head_state
    root = state.hash_tree_root()
    br = sync_committee_branch(state, "current_sync_committee")
    assert is_valid_merkle_branch(
        state.current_sync_committee.hash_tree_root(), br,
        SYNC_COMMITTEE_BRANCH_DEPTH, 22, root,
    )
    br2 = sync_committee_branch(state, "next_sync_committee")
    assert is_valid_merkle_branch(
        state.next_sync_committee.hash_tree_root(), br2,
        SYNC_COMMITTEE_BRANCH_DEPTH, 23, root,
    )
    fb = finality_branch(state)
    assert is_valid_merkle_branch(
        bytes(state.finalized_checkpoint.root), fb,
        FINALITY_BRANCH_DEPTH, 20 * 2 + 1, root,
    )


def test_import_produces_lc_updates(harness):
    harness.extend_chain(harness.spec.slots_per_epoch * 5)
    lc = harness.chain.lc_cache
    assert lc.latest_optimistic_update is not None
    assert lc.latest_finality_update is not None
    assert lc.best_updates, "no period updates cached"
    opt = lc.latest_optimistic_update
    assert any(opt.sync_aggregate.sync_committee_bits)


def test_lc_store_follows_chain_across_period(harness):
    """Bootstrap from a finalized root, then replay served updates through
    the VERIFYING store across a sync-committee period boundary."""
    chain = harness.chain
    spe = harness.spec.slots_per_epoch
    harness.extend_chain(spe * 5)  # get finality established
    f_epoch, f_root = chain.finalized_checkpoint()
    assert f_epoch >= 1

    bootstrap = chain.produce_light_client_bootstrap(f_root)
    assert bootstrap is not None
    store = LightClientStore(harness.types, harness.spec, chain.genesis_validators_root)
    store.bootstrap(f_root, bootstrap)
    assert int(store.finalized_header.beacon.slot) == int(
        chain.get_block(f_root).message.slot
    )

    # cross at least one full period beyond the bootstrap
    harness.extend_chain(spe * 3)
    start_period = store._period(int(store.finalized_header.beacon.slot))
    updates = chain.lc_cache.get_updates(start_period, 8)
    assert updates, "no updates served for the bootstrap period onwards"
    before = int(store.finalized_header.beacon.slot)
    for u in updates:
        store.process_update(u)
    assert int(store.finalized_header.beacon.slot) > before, (
        "LC store did not advance through served updates"
    )
    # and the latest finality update still applies on top
    fin = chain.lc_cache.latest_finality_update
    store.process_finality_update(fin)
    assert int(store.optimistic_header.beacon.slot) >= int(
        fin.attested_header.beacon.slot
    )


def test_lc_store_rejects_tampered_branch(harness):
    chain = harness.chain
    spe = harness.spec.slots_per_epoch
    harness.extend_chain(spe * 5)
    _, f_root = chain.finalized_checkpoint()
    bootstrap = chain.produce_light_client_bootstrap(f_root)
    tampered = bootstrap.copy()
    tampered.current_sync_committee_branch = [
        b"\x66" * 32 for _ in tampered.current_sync_committee_branch
    ]
    store = LightClientStore(harness.types, harness.spec, chain.genesis_validators_root)
    with pytest.raises(LightClientError, match="branch"):
        store.bootstrap(f_root, tampered)


def test_electra_lc_era_end_to_end():
    """Electra's 37-field state (depth 6/7 gindices): branches verify, the
    server produces the electra container variants, and the verifying store
    follows the chain."""
    from lighthouse_tpu_torch.chain.light_client import lc_era, state_depth

    set_backend("fake")
    spec = lc_spec(deneb_fork_epoch=0, electra_fork_epoch=0)
    hs = BeaconChainHarness(validator_count=16, spec=spec, fake_crypto=True)
    chain = hs.chain
    state = chain.head_state
    assert type(state).fork_name == "electra"
    assert state_depth(state) == 6 and lc_era(state) == "electra"

    root = state.hash_tree_root()
    br = sync_committee_branch(state, "current_sync_committee")
    assert len(br) == 6
    assert is_valid_merkle_branch(
        state.current_sync_committee.hash_tree_root(), br, 6, 22, root
    )
    fb = finality_branch(state)
    assert len(fb) == 7
    assert is_valid_merkle_branch(
        bytes(state.finalized_checkpoint.root), fb, 7, 20 * 2 + 1, root
    )

    spe = spec.slots_per_epoch
    hs.extend_chain(spe * 5)
    _, f_root = chain.finalized_checkpoint()
    bootstrap = chain.produce_light_client_bootstrap(f_root)
    assert type(bootstrap).__name__ == "LightClientBootstrapElectra"
    store = LightClientStore(hs.types, spec, chain.genesis_validators_root)
    store.bootstrap(f_root, bootstrap)

    hs.extend_chain(spe * 3)
    updates = chain.lc_cache.get_updates(
        store._period(int(store.finalized_header.beacon.slot)), 8
    )
    assert updates and type(updates[0]).__name__ == "LightClientUpdateElectra"
    before = int(store.finalized_header.beacon.slot)
    for u in updates:
        store.process_update(u)
    assert int(store.finalized_header.beacon.slot) > before


class TestExecutionHeaders:
    """capella+ LC headers carry the execution payload header + the 4-deep
    execution_branch (reference light_client_header.rs:40-59)."""

    def test_served_headers_carry_verified_execution(self, harness):
        from lighthouse_tpu_torch.light_client import is_valid_light_client_header

        harness.extend_chain(harness.spec.slots_per_epoch * 5)
        cache = harness.chain.lc_cache
        upd = cache.latest_finality_update
        assert upd is not None
        for hdr in (upd.attested_header, upd.finalized_header):
            assert "execution" in hdr.fields, "capella header must carry execution"
            assert any(bytes(h) != b"\x00" * 32 for h in hdr.execution_branch)
            assert is_valid_light_client_header(hdr)
        # the execution header is the block's actual payload summary
        att_root = upd.attested_header.beacon.hash_tree_root()
        blk = harness.chain.get_block(att_root)
        assert bytes(upd.attested_header.execution.block_hash) == bytes(
            blk.message.body.execution_payload.block_hash
        )

    def test_tampered_execution_root_rejected(self, harness):
        spe = harness.spec.slots_per_epoch
        harness.extend_chain(spe * 5)
        chain = harness.chain
        froot = bytes(chain.head_state.finalized_checkpoint.root)
        bootstrap = chain.produce_light_client_bootstrap(froot)
        assert bootstrap is not None and "execution" in bootstrap.header.fields

        store = LightClientStore(harness.types, harness.spec,
                                 bytes(chain.genesis_state.genesis_validators_root))
        store.bootstrap(froot, bootstrap)
        # replay period updates so the store's committee reaches the head
        for u in chain.lc_cache.get_updates(store.committee_period, 16):
            store.process_update(u)

        upd = chain.lc_cache.latest_finality_update
        assert upd is not None
        bad = type(upd).from_ssz_bytes(upd.as_ssz_bytes())  # deep copy via SSZ
        bad.attested_header.execution.state_root = b"\x66" * 32
        with pytest.raises(LightClientError, match="execution"):
            store.process_finality_update(bad)
        # untampered original still applies
        store.process_finality_update(upd)
        assert store.finalized_header is not None

    def test_ssz_and_json_round_trip(self, harness):
        from lighthouse_tpu_torch.http_api.serde import container_from_json, to_json

        harness.extend_chain(harness.spec.slots_per_epoch * 5)
        upd = harness.chain.lc_cache.latest_finality_update
        cls = type(upd)
        assert cls.__name__ == "LightClientFinalityUpdateCapella"
        assert cls.from_ssz_bytes(upd.as_ssz_bytes()).hash_tree_root() \
            == upd.hash_tree_root()
        assert container_from_json(cls, to_json(upd)).hash_tree_root() \
            == upd.hash_tree_root()


def test_rpc_light_client_syncs_over_wire():
    """A verifying light client bootstraps and follows a peer ENTIRELY over
    the spec light-client req/resp protocols — no local chain handle."""
    from lighthouse_tpu_torch.light_client import RpcLightClient
    from lighthouse_tpu_torch.network import rpc as rpc_mod
    from lighthouse_tpu_torch.network.node import LocalNode
    from lighthouse_tpu_torch.network.rate_limiter import Quota
    from lighthouse_tpu_torch.network.transport import Hub

    set_backend("fake")
    hub = Hub()
    genesis = 1_600_000_000
    ha = BeaconChainHarness(validator_count=16, fake_crypto=True, genesis_time=genesis)
    hb = BeaconChainHarness(validator_count=16, fake_crypto=True, genesis_time=genesis)
    na = LocalNode(hub=hub, peer_id="serve", harness=ha)
    nb = LocalNode(hub=hub, peer_id="watch", harness=hb)
    hub.connect("serve", "watch")
    try:
        for proto in (rpc_mod.LIGHT_CLIENT_BOOTSTRAP,
                      rpc_mod.LIGHT_CLIENT_OPTIMISTIC_UPDATE):
            na.service.rate_limiter.quotas[proto] = Quota(8, 10.0)
            nb.service.self_limiter.quotas[proto] = Quota(8, 10.0)
        trusted = None
        for _ in range(3):
            slot = ha.advance_slot()
            hb.advance_slot()
            signed = ha.produce_signed_block(slot=slot)
            ha.chain.process_block(signed)
            if trusted is None:
                trusted = ha.chain.head_root
        lc = RpcLightClient(
            service=nb.service, peer="serve", types=ha.chain.types,
            spec=ha.chain.spec,
            genesis_validators_root=ha.chain.genesis_validators_root)
        lc.sync_from_peer(trusted)
        # the wire-synced store follows the serving chain's view
        assert lc.store.finalized_header is not None
        opt = ha.chain.lc_cache.latest_optimistic_update
        assert (bytes(lc.store.optimistic_header.beacon.hash_tree_root())
                == bytes(opt.attested_header.beacon.hash_tree_root()))
    finally:
        na.shutdown()
        nb.shutdown()


# ------------------------------------------------------------------- parity


def store_view(store) -> tuple:
    return (store.committee_period,
            store.finalized_header.as_ssz_bytes(), store.optimistic_header.as_ssz_bytes(),
            store.current_sync_committee.as_ssz_bytes(),
            None if store.next_sync_committee is None
            else store.next_sync_committee.as_ssz_bytes())


def refusal(fn) -> str:
    with pytest.raises((LightClientError, JLightClientError)) as info:
        fn()
    return str(info.value)


def test_both_stores_agree_on_one_schedule():
    """One schedule in both packages: equal bootstraps and updates; each
    store fed the other package's objects ends where the other's does; the
    same tampered inputs are refused with the same message."""
    j_preset = dataclasses.replace(J_MINIMAL_PRESET, epochs_per_sync_committee_period=2)
    with jax_backend("fake"):
        jhs = JHarness(validator_count=16, spec=j_minimal_spec(preset=j_preset, **SCHEDULE),
                       fake_crypto=True)
    jhs.chain.graffiti_calculator.beacon_graffiti = JGraffitiOrigin.user(GRAFFITI)
    set_backend("fake")
    phs = BeaconChainHarness(validator_count=16, spec=lc_spec(), fake_crypto=True)
    phs.chain.graffiti_calculator.beacon_graffiti = GraffitiOrigin.user(GRAFFITI)
    spe = phs.spec.slots_per_epoch
    with jax_backend("fake"):
        jhs.extend_chain(spe * 5)
    phs.extend_chain(spe * 5)
    jchain, pchain = jhs.chain, phs.chain
    assert jchain.head_root == pchain.head_root
    f_root = pchain.finalized_checkpoint()[1]
    assert jchain.finalized_checkpoint()[1] == f_root
    jboot = jchain.produce_light_client_bootstrap(f_root)
    pboot = pchain.produce_light_client_bootstrap(f_root)
    assert jboot.as_ssz_bytes() == pboot.as_ssz_bytes()

    with jax_backend("fake"):
        jhs.extend_chain(spe * 3)
    phs.extend_chain(spe * 3)
    gvr = pchain.genesis_validators_root
    jstore = JLightClientStore(jhs.types, jhs.spec, gvr)
    pstore = LightClientStore(phs.types, phs.spec, gvr)
    # each store takes the other package's objects, by their SSZ bytes
    pstore.bootstrap(f_root, type(pboot).from_ssz_bytes(jboot.as_ssz_bytes()))
    jstore.bootstrap(f_root, type(jboot).from_ssz_bytes(pboot.as_ssz_bytes()))
    start = pstore.committee_period
    jups, pups = jchain.lc_cache.get_updates(start, 8), pchain.lc_cache.get_updates(start, 8)
    assert [u.as_ssz_bytes() for u in jups] == [u.as_ssz_bytes() for u in pups]
    with jax_backend("fake"):
        for u in pups:
            jstore.process_update(type(jups[0]).from_ssz_bytes(u.as_ssz_bytes()))
    for u in jups:
        pstore.process_update(type(pups[0]).from_ssz_bytes(u.as_ssz_bytes()))
    assert store_view(jstore) == store_view(pstore)
    jfin, pfin = jchain.lc_cache.latest_finality_update, pchain.lc_cache.latest_finality_update
    assert jfin.as_ssz_bytes() == pfin.as_ssz_bytes()

    # the refusals: a tampered branch, a tampered execution root, too few
    # participants
    jbad, pbad = jboot.copy(), pboot.copy()
    for bad in (jbad, pbad):
        bad.current_sync_committee_branch = [b"\x66" * 32] * len(
            bad.current_sync_committee_branch)
    j_store2 = JLightClientStore(jhs.types, jhs.spec, gvr)
    p_store2 = LightClientStore(phs.types, phs.spec, gvr)
    assert refusal(lambda: j_store2.bootstrap(f_root, jbad)) == \
        refusal(lambda: p_store2.bootstrap(f_root, pbad))
    jx, px = type(jfin).from_ssz_bytes(jfin.as_ssz_bytes()), \
        type(pfin).from_ssz_bytes(pfin.as_ssz_bytes())
    for bad in (jx, px):
        bad.attested_header.execution.state_root = b"\x66" * 32
    with jax_backend("fake"):
        j_msg = refusal(lambda: jstore.process_finality_update(jx))
    assert j_msg == refusal(lambda: pstore.process_finality_update(px))
    for bad in (jx, px):
        bad.attested_header.execution.state_root = pfin.attested_header.execution.state_root
        bad.sync_aggregate.sync_committee_bits = [False] * len(
            bad.sync_aggregate.sync_committee_bits)
    with jax_backend("fake"):
        j_msg = refusal(lambda: jstore.process_finality_update(jx))
    assert j_msg == refusal(lambda: pstore.process_finality_update(px))
    assert store_view(jstore) == store_view(pstore)
