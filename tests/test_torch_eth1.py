"""The port's eth1 follower (``eth1/``: ``DepositCache``, ``Eth1Service``,
``Eth1GenesisService``) vs the JAX package's.

Every comparison is exact (roots, proofs, votes, state bytes):

- ``DepositCache``: the deposit root at every count and every deposit's
  proof at every count equal, each proof valid under both packages'
  ``is_valid_merkle_branch``; the same refusals;
- ``chip_smoke.eth1_run`` (the eth1 path ``chip_smoke.py``'s
  ``[chain-harness]`` drives on the card: one deposit from a provider
  through the service into a produced block and imported) against the same
  steps on the JAX package: the block root, the post-state's bytes and
  the registry;
- the JAX package's ``test_eth1.py`` voting and deposit-triggered genesis
  cases on both packages: the same votes and the same genesis state bytes.
"""

import pytest
import torch

pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from lighthouse_tpu.chain import BeaconChain as JChain  # noqa: E402
from lighthouse_tpu.chain import BeaconChainHarness as JHarness  # noqa: E402
from lighthouse_tpu.chain import ManualSlotClock as JClock  # noqa: E402
from lighthouse_tpu.chain import MockExecutionEngine as JEngine  # noqa: E402
from lighthouse_tpu.chain.harness import interop_genesis_state as j_genesis  # noqa: E402
from lighthouse_tpu.consensus import genesis as jgenesis  # noqa: E402
from lighthouse_tpu.consensus.per_block import is_valid_merkle_branch as j_valid  # noqa: E402
from lighthouse_tpu.consensus.signature_sets import deposit_signature_message as j_msg  # noqa: E402
from lighthouse_tpu.eth1 import DepositCache as JCache  # noqa: E402
from lighthouse_tpu.eth1 import Eth1Error as JEth1Error  # noqa: E402
from lighthouse_tpu.eth1 import Eth1GenesisService as JGenesisService  # noqa: E402
from lighthouse_tpu.eth1 import Eth1Service as JService  # noqa: E402
from lighthouse_tpu.types.containers import build_types as j_build_types  # noqa: E402
from lighthouse_tpu.types.spec import minimal_spec as j_minimal_spec  # noqa: E402
from lighthouse_tpu_torch.consensus.per_block import is_valid_merkle_branch  # noqa: E402
from lighthouse_tpu_torch.eth1 import DepositCache, Eth1Error, Eth1GenesisService, Eth1Service  # noqa: E402
from lighthouse_tpu_torch.types.containers import build_types  # noqa: E402
from lighthouse_tpu_torch.types.spec import minimal_spec  # noqa: E402
from test_torch_chain import harnesses, jax_backend, port_cpu, specs  # noqa: E402,F401

VALIDATORS = 16
DEPOSIT_DEPTH = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def j_deposit_data(types, spec, index: int, amount=None):
    """``chip_smoke.deposit_data`` on the JAX package."""
    sk = jgenesis.interop_secret_key(index)
    pk = sk.public_key().to_bytes()
    data = types.DepositData(pubkey=pk,
                             withdrawal_credentials=jgenesis.interop_withdrawal_credentials(pk),
                             amount=spec.max_effective_balance if amount is None else amount)
    data.signature = sk.sign(j_msg(data, types, spec)).to_bytes()
    return data


class JProvider:
    """``chip_smoke.Eth1Provider`` on the JAX package's ``DepositCache``."""

    def __init__(self, types):
        self.cache, self.blocks = JCache(types), []

    add_deposits = chip_smoke.Eth1Provider.add_deposits
    eth1_blocks = chip_smoke.Eth1Provider.eth1_blocks
    deposit_logs = chip_smoke.Eth1Provider.deposit_logs


def caches(n: int):
    j_spec, p_spec = specs({})
    jt, pt = j_build_types(j_spec.preset), build_types(p_spec.preset)
    datas = [chip_smoke.deposit_data(pt, p_spec, i) for i in range(n)]
    j_datas = [j_deposit_data(jt, j_spec, i) for i in range(n)]
    assert [d.as_ssz_bytes() for d in datas] == [d.as_ssz_bytes() for d in j_datas]
    pc, jc = DepositCache(pt), JCache(jt)
    for i, (d, jd) in enumerate(zip(datas, j_datas)):
        pc.insert_log(i, d)
        jc.insert_log(i, jd)
    return pc, jc


def test_deposit_roots_and_proofs_match_jax():
    pc, jc = caches(6)
    for count in range(7):
        root = pc.deposit_root(count)
        assert root == jc.deposit_root(count)
        if count == 0:
            continue
        deposits = pc.get_deposits(0, count, count)
        assert [d.as_ssz_bytes() for d in deposits] == \
            [d.as_ssz_bytes() for d in jc.get_deposits(0, count, count)]
        for i, dep in enumerate(deposits):
            leaf = dep.data.hash_tree_root()
            assert is_valid_merkle_branch(leaf, dep.proof, DEPOSIT_DEPTH + 1, i, root)
            assert j_valid(leaf, dep.proof, DEPOSIT_DEPTH + 1, i, root)
            assert not is_valid_merkle_branch(leaf, dep.proof, DEPOSIT_DEPTH + 1, i + 1, root)


def test_deposit_cache_refusals_match_jax():
    pc, jc = caches(3)
    out = []
    for cache, error in ((jc, JEth1Error), (pc, Eth1Error)):
        cache.insert_log(1, cache._deposit_data[1])  # a replayed log is ignored
        with pytest.raises(error) as gap:
            cache.insert_log(5, cache._deposit_data[0])
        with pytest.raises(error) as beyond:
            cache.get_deposits(0, 4, 4)
        out.append((len(cache), str(gap.value), str(beyond.value)))
    assert out[0] == out[1]
    assert out[1][0] == 3


def j_eth1_run(validators: int) -> dict:
    """``chip_smoke.eth1_run``'s steps on the JAX package."""
    from lighthouse_tpu.eth1 import Eth1Service as Service

    hs = JHarness(validator_count=validators)
    types, spec = hs.types, hs.spec
    genesis = j_genesis(validators, types, spec, genesis_time=int(hs.chain.genesis_time))
    provider = JProvider(types)
    old = int(genesis.genesis_time) - spec.seconds_per_eth1_block * spec.eth1_follow_distance
    provider.add_deposits([j_deposit_data(types, spec, i) for i in range(validators)], old - 1010)
    provider.add_deposits([j_deposit_data(types, spec, chip_smoke.ETH1_NEW_VALIDATOR)],
                          old - 1000)
    tip = provider.blocks[-1]
    genesis.eth1_data = types.Eth1Data(deposit_root=tip["deposit_root"],
                                       deposit_count=tip["deposit_count"], block_hash=tip["hash"])
    hs.chain = JChain(genesis_state=genesis, types=types, spec=spec,
                      slot_clock=JClock(int(genesis.genesis_time), spec.seconds_per_slot),
                      execution_engine=JEngine())
    service = Service(provider=provider, types=types, spec=spec)
    service.update()
    hs.chain.eth1_service = service
    hs.advance_slot()
    signed = hs.produce_signed_block(graffiti=chip_smoke.HARNESS_GRAFFITI)
    root = hs.chain.process_block(signed)
    state = hs.chain.head_state
    return {"root": root, "state_root": state.hash_tree_root(), "state_ssz": state.as_ssz_bytes(),
            "deposit_root": bytes(tip["deposit_root"]), "registry": len(state.validators),
            "balance": int(state.balances[-1])}


def test_eth1_block_with_deposit_matches_jax():
    """The fake backend (real signatures), as ``[chain-harness]``'s CPU path
    runs it: the same block, post-state and registry in both packages."""
    from lighthouse_tpu_torch.crypto.bls.backends import set_backend

    with jax_backend("fake"):
        expected = j_eth1_run(VALIDATORS)
    set_backend("fake")
    got = chip_smoke.eth1_run(VALIDATORS)
    assert got == expected
    assert got["registry"] == VALIDATORS + 1


def vote_run(hs, service_cls, provider, deposit_fn) -> list:
    """The JAX package's voting case: the newest in-window candidate with
    no ballots, the majority's, and out-of-window ballots ignored."""
    types, spec = hs.types, hs.spec
    service = service_cls(provider=provider, types=types, spec=spec)
    state = hs.chain.head_state.copy()
    period_start = service._voting_period_start_time(state)
    in_window = period_start - spec.seconds_per_eth1_block * spec.eth1_follow_distance - 10
    provider.add_deposits([deposit_fn(types, spec, i) for i in range(VALIDATORS)], in_window)
    provider.add_deposits([], in_window + 1)
    service.update()
    votes = [bytes(service.eth1_vote(state).block_hash)]
    older = provider.blocks[-2]
    state.eth1_data_votes = [types.Eth1Data(deposit_root=older["deposit_root"],
                                            deposit_count=older["deposit_count"],
                                            block_hash=older["hash"])] * 3
    votes.append(bytes(service.eth1_vote(state).block_hash))
    state.eth1_data_votes = [types.Eth1Data(deposit_root=b"\x77" * 32, deposit_count=99,
                                            block_hash=b"\x88" * 32)] * 5
    votes.append(bytes(service.eth1_vote(state).block_hash))
    state.eth1_data_votes = []
    votes.append(service.deposits_for_block(state))
    return votes


def test_eth1_vote_matches_jax():
    jhs, phs = harnesses({}, validators=VALIDATORS)
    j_votes = vote_run(jhs, JService, JProvider(jhs.types), j_deposit_data)
    p_votes = vote_run(phs, Eth1Service, chip_smoke.Eth1Provider(phs.types),
                       chip_smoke.deposit_data)
    assert p_votes == j_votes
    assert p_votes[:3] == [bytes([2]) * 32, bytes([1]) * 32, bytes([2]) * 32]


def genesis_run(spec_fn, types_fn, provider, service_cls, deposit_fn) -> list:
    spec = spec_fn(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
                   deneb_fork_epoch=None)
    spec.min_genesis_active_validator_count = 4
    spec.min_genesis_time = 1_500_000_000
    types = types_fn(spec.preset)
    provider = provider(types)
    svc = service_cls(provider=provider, types=types, spec=spec)
    out = [svc.try_genesis()]
    provider.add_deposits([deposit_fn(types, spec, i) for i in range(3)], 1_500_000_100)
    out.append(svc.try_genesis())
    provider.add_deposits([deposit_fn(types, spec, 3)], 1_500_000_200)
    state = svc.try_genesis()
    out.append((state.as_ssz_bytes(), int(state.genesis_time) - spec.genesis_delay,
                bytes(state.eth1_data.deposit_root) == provider.cache.deposit_root()))
    return out


def test_deposit_triggered_genesis_matches_jax():
    got = genesis_run(minimal_spec, build_types, chip_smoke.Eth1Provider, Eth1GenesisService,
                      chip_smoke.deposit_data)
    assert got == genesis_run(j_minimal_spec, j_build_types, JProvider, JGenesisService,
                              j_deposit_data)
    assert got[:2] == [None, None] and got[2][1:] == (1_500_000_200, True)
