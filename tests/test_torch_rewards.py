"""The port's reward calculators (``chain/rewards.py``) vs the JAX
package's.

- The JAX package's ``test_rewards.py`` re-pointed at the port: reward
  numbers reconcile with the balances the transition applied, over HTTP
  too, and the validator monitor tracks inclusion and proposals;
- parity: ``attestation_rewards``, ``sync_committee_rewards`` and
  ``block_rewards`` equal the JAX package's, exactly, on the same states
  (the JAX package's states carried across as SSZ bytes, and both
  packages' harness chains on one schedule for ``block_rewards``), for
  every validator and for a subset, in a few fork schedules.

Chains run on the port's CPU routes (host tree hashing, the numpy epoch
backend) with fake crypto.
"""

import pytest

pytest.importorskip("jax")

from lighthouse_tpu.chain import rewards as jrewards  # noqa: E402
from lighthouse_tpu.consensus.per_slot import process_slots as j_process_slots  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.chain.rewards import (  # noqa: E402
    attestation_rewards,
    block_rewards,
    sync_committee_rewards,
)
from lighthouse_tpu_torch.consensus.per_slot import process_slots  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.http_api import BeaconNodeHttpClient, HttpApiServer  # noqa: E402
from lighthouse_tpu_torch.types.spec import (  # noqa: E402
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
)
from test_torch_chain import harnesses, jax_backend  # noqa: E402
from test_torch_http_api import one_torch_thread, port_cpu_module  # noqa: E402,F401
from test_torch_types import to_port  # noqa: E402

#: Fork schedules for parity: the harness's default (capella from
#: genesis), phase0 into altair at the first boundary, deneb from genesis.
SCHEDULES = {
    "capella": {},
    "phase0-altair": dict(altair_fork_epoch=1, bellatrix_fork_epoch=None,
                          capella_fork_epoch=None, deneb_fork_epoch=None,
                          electra_fork_epoch=None),
    "deneb": dict(deneb_fork_epoch=0),
}


@pytest.fixture(scope="module")
def harness():
    set_backend("fake")
    hs = BeaconChainHarness(validator_count=16, fake_crypto=True)
    hs.extend_chain(hs.spec.slots_per_epoch * 4)
    yield hs
    set_backend("host")


# --------------------------------------------- the JAX package's test_rewards


def test_attestation_rewards_match_epoch_processing(harness):
    """Full participation => each flag's ideal reward, no penalties."""
    chain = harness.chain
    spe = harness.spec.slots_per_epoch
    epoch = int(chain.head_state.slot) // spe - 1
    state, _ = chain.state_at_slot((epoch + 1) * spe)
    data = attestation_rewards(state, harness.spec)
    assert len(data["total_rewards"]) == 16
    assert data["ideal_rewards"], "ideal rewards table empty"
    ideal = data["ideal_rewards"][0]
    flags = [int(x) for x in state.previous_epoch_participation]
    for row in data["total_rewards"]:
        i = int(row["validator_index"])
        for name, idx in (("source", TIMELY_SOURCE_FLAG_INDEX),
                          ("target", TIMELY_TARGET_FLAG_INDEX),
                          ("head", TIMELY_HEAD_FLAG_INDEX)):
            got = int(row[name])
            if flags[i] & (1 << idx):
                assert got == int(ideal[name]), (name, row)
            elif name == "head":
                assert got == 0, row
            else:
                assert got < 0, (name, row)
        assert int(row["inactivity"]) == 0, row


def test_sync_committee_rewards_match_balance_delta(harness):
    chain = harness.chain
    head = chain.get_block(chain.head_root)
    pre = chain.get_state(bytes(head.message.parent_root)).copy()
    if int(pre.slot) < int(head.message.slot):
        pre = process_slots(pre, int(head.message.slot), harness.types, harness.spec)
    rows = sync_committee_rewards(pre, head, harness.spec)
    assert rows, "full-participation block should have sync rewards"
    assert all(int(r["reward"]) > 0 for r in rows)


def test_block_rewards_breakdown(harness):
    chain = harness.chain
    data = block_rewards(chain, chain.head_root)
    assert data is not None
    total = int(data["total"])
    sync = int(data["sync_aggregate"])
    atts = int(data["attestations"])
    assert total == sync + atts
    assert sync > 0, "full sync participation must credit the proposer"
    assert total > 0


def test_rewards_http_routes(harness):
    chain = harness.chain
    server = HttpApiServer(chain).start()
    try:
        client = BeaconNodeHttpClient(server.url)
        spe = harness.spec.slots_per_epoch
        epoch = int(chain.head_state.slot) // spe - 1
        resp = client.post(f"/eth/v1/beacon/rewards/attestations/{epoch}",
                           ["0", "3"])
        rows = resp["data"]["total_rewards"]
        assert [r["validator_index"] for r in rows] == ["0", "3"]
        assert resp["data"] == attestation_rewards(
            chain.head_state, harness.spec, [0, 3])
        blk = client.get("/eth/v1/beacon/rewards/blocks/head")
        assert int(blk["data"]["total"]) > 0
        assert blk["data"] == block_rewards(chain, chain.head_root)
        sync = client.post("/eth/v1/beacon/rewards/sync_committee/head", None)
        assert sync["data"]
    finally:
        server.stop()


def test_validator_monitor_tracks_inclusion_and_proposals(harness):
    chain = harness.chain
    server = HttpApiServer(chain).start()
    try:
        client = BeaconNodeHttpClient(server.url)
        client.post("/lighthouse/ui/validator_monitor", ["1", "2", "15"])
        spe = harness.spec.slots_per_epoch
        harness.extend_chain(spe * 2)  # everyone attests + proposes
        epoch = int(chain.head_state.slot) // spe - 1
        summary = client.get(f"/lighthouse/ui/validator_monitor/{epoch}")["data"]
        assert summary["monitored"] == 3
        assert summary["attestation_included"] == [1, 2, 15], summary
        assert summary["attestation_missed"] == []

        harness.extend_chain(spe * 2)  # close at least one fully-attested epoch
        m = client.post("/lighthouse/ui/validator_metrics",
                        {"indices": ["1", "2", "15", "9"]})["data"]["validators"]
        assert set(m) == {"1", "2", "15"}  # 9 is not monitored
        for v in ("1", "2", "15"):
            assert m[v]["attestation_hits"] >= 1, m[v]
            assert m[v]["attestation_hit_percentage"] > 0.0
            assert m[v]["latest_attestation_inclusion_distance"] >= 1
    finally:
        server.stop()


# -------------------------------------------------------------------- parity


@pytest.fixture(scope="module", params=sorted(SCHEDULES))
def chains(request):
    """Both packages' harness chains on one schedule, 3 epochs and 3 slots
    in, with a skipped slot and a block without attestations on the way."""
    jhs, phs = harnesses(SCHEDULES[request.param], validators=16)
    spe = phs.spec.slots_per_epoch

    def extend(hs):
        hs.extend_chain(spe + 2)
        hs.advance_slot()  # a skipped slot
        hs.extend_chain(1, attest=False)
        hs.extend_chain(spe + spe - 2)

    with jax_backend("fake"):
        extend(jhs)
    set_backend("fake")
    extend(phs)
    assert jhs.chain.head_root == phs.chain.head_root
    return jhs, phs


def test_attestation_rewards_match_jax(chains):
    jhs, phs = chains
    j_state = jhs.chain.head_state
    p_state = to_port(j_state, phs.types)
    for ids in (None, [0, 3, 15], [7]):
        assert attestation_rewards(p_state, phs.spec, ids) == \
            jrewards.attestation_rewards(j_state, jhs.spec, ids)


def test_sync_committee_rewards_match_jax(chains):
    jhs, phs = chains
    head = jhs.chain.get_block(jhs.chain.head_root)
    slot = int(head.message.slot)
    j_pre = j_process_slots(jhs.chain.get_state(bytes(head.message.parent_root)).copy(),
                            slot, jhs.types, jhs.spec)
    p_pre = to_port(j_pre, phs.types)
    p_head = phs.types.signed_block[type(head.message).fork_name].from_ssz_bytes(
        head.as_ssz_bytes())
    for ids in (None, [0, 3, 15]):
        got = sync_committee_rewards(p_pre, p_head, phs.spec, ids)
        assert got == jrewards.sync_committee_rewards(j_pre, head, jhs.spec, ids)
    assert got


def test_block_rewards_match_jax(chains):
    jhs, phs = chains
    spe = phs.spec.slots_per_epoch
    roots = [jhs.chain.block_root_at_slot(s) for s in range(1, 3 * spe + 3)]
    roots = [r for r in dict.fromkeys(roots) if r is not None]
    assert len(roots) >= 3 * spe
    for root in roots:
        assert block_rewards(phs.chain, root) == jrewards.block_rewards(jhs.chain, root)
