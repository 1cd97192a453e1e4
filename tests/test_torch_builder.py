"""The port's builder path (``execution_layer/builder_client.py``,
``http_api/serde.py``, ``BeaconChain.produce_blinded_block`` /
``unblind_and_import``) vs the JAX package's.

Every comparison is exact (roots, state bytes, JSON, error classes and
messages):

- ``chip_smoke.builder_run`` (the builder path ``chip_smoke.py``'s
  ``[chain-harness]`` drives on the card) on a 16-validator real-crypto
  harness, the port's ``"torch"`` backend on the CPU, against the same
  steps on the JAX package with its host backend: the blinded and the
  imported block roots, the post-state's bytes and the tampered reveal's
  refusal;
- the pinned relay identity and a relay that is down: the same error;
- the JAX package's electra blinded round trip (the fake backend), both
  packages' roots equal;
- registrations reach the relay; ``builder_signing_root`` and the bid's
  beacon-API JSON equal.
"""

import pytest
import torch

pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from lighthouse_tpu.chain import BeaconChainHarness as JHarness  # noqa: E402
from lighthouse_tpu.chain.beacon_chain import BlockError as JBlockError  # noqa: E402
from lighthouse_tpu.chain.beacon_chain import ChainError as JChainError  # noqa: E402
from lighthouse_tpu.consensus import helpers as jh  # noqa: E402
from lighthouse_tpu.execution_layer import builder_client as jbc  # noqa: E402
from lighthouse_tpu.http_api import serde as jserde  # noqa: E402
from lighthouse_tpu.types.spec import DOMAIN_BEACON_PROPOSER as J_DOMAIN_BEACON_PROPOSER  # noqa: E402
from lighthouse_tpu_torch.chain.beacon_chain import ChainError  # noqa: E402
from lighthouse_tpu_torch.consensus import helpers as h  # noqa: E402
from lighthouse_tpu_torch.execution_layer import builder_client as pbc  # noqa: E402
from lighthouse_tpu_torch.http_api import container_from_json, to_json  # noqa: E402
from test_torch_chain import harnesses, jax_backend, port_cpu, specs  # noqa: E402,F401

VALIDATORS = 16
ELECTRA = dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
               deneb_fork_epoch=0, electra_fork_epoch=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def j_sign_blinded(hs, block):
    slot = int(block.slot)
    state, _ = hs.chain.state_at_slot(slot)
    domain = hs._domain_at(state, J_DOMAIN_BEACON_PROPOSER, slot // hs.spec.slots_per_epoch)
    sig = hs._sign(int(block.proposer_index),
                   jh.compute_signing_root(block.hash_tree_root(), domain))
    return hs.types.signed_blinded_block[type(block).fork_name](message=block,
                                                               signature=sig.to_bytes())


def j_builder_run(validators: int, **harness_kw) -> dict:
    """``chip_smoke.builder_run``'s steps on the JAX package."""
    hs = JHarness(validator_count=validators, **harness_kw)
    chain = hs.chain
    relay = jbc.MockRelay(chain).start()
    try:
        chain.builder = jbc.BuilderHttpClient(relay.url)
        chain.builder_pubkey = relay.pubkey

        def blinded():
            slot = hs.advance_slot()
            state, _ = chain.state_at_slot(slot)
            reveal = hs.randao_reveal(state, slot, jh.get_beacon_proposer_index(state, hs.spec))
            block, _ = chain.produce_blinded_block(slot, reveal,
                                                   graffiti=chip_smoke.HARNESS_GRAFFITI)
            return block

        block = blinded()
        blinded_root = block.hash_tree_root()
        root, full = chain.unblind_and_import(j_sign_blinded(hs, block))
        tampered = blinded()
        tampered.body.execution_payload_header.gas_limit = 123
        with pytest.raises(JBlockError) as err:
            chain.unblind_and_import(j_sign_blinded(hs, tampered))
        return {"blinded_root": blinded_root, "root": root,
                "state_root": chain.head_state.hash_tree_root(),
                "state_ssz": chain.head_state.as_ssz_bytes(),
                "payload_root": full.message.body.execution_payload.hash_tree_root(),
                "refusal": f"{type(err.value).__name__}: {err.value}"}
    finally:
        relay.stop()


def test_builder_run_matches_jax():
    """Real crypto: the bid and the block verified by the port's
    ``"torch"`` backend on the CPU and by the JAX package's host backend."""
    with jax_backend("host"):
        expected = j_builder_run(VALIDATORS)
    got = chip_smoke.builder_run(VALIDATORS)
    assert got == expected
    assert got["root"] == got["blinded_root"]
    assert "no payload for that header (not our bid)" in got["refusal"]
    assert got["refusal"].startswith("BlockError: builder failed to reveal payload")


def test_electra_blinded_round_trip_matches_jax():
    """Electra from genesis, the fake backend: the bid carries
    ExecutionRequests, the blinded body embeds them, the unblinded root is
    the signed one, in both packages alike."""
    from lighthouse_tpu_torch.crypto.bls.backends import set_backend

    j_spec, p_spec = specs(ELECTRA)
    with jax_backend("fake"):
        expected = j_builder_run(VALIDATORS, spec=j_spec)
    set_backend("fake")
    got = chip_smoke.builder_run(VALIDATORS, spec=p_spec)
    assert got == expected
    assert got["root"] == got["blinded_root"]


def refusal(hs, bc_mod, helpers, error_cls, setup) -> str:
    """The error ``produce_blinded_block`` raises after ``setup(chain,
    relay)`` on a fresh fake-crypto rig."""
    chain = hs.chain
    relay = bc_mod.MockRelay(chain).start()
    try:
        chain.builder = bc_mod.BuilderHttpClient(relay.url)
        setup(chain, relay)
        slot = hs.advance_slot()
        state, _ = chain.state_at_slot(slot)
        reveal = hs.randao_reveal(state, slot, helpers.get_beacon_proposer_index(state, hs.spec))
        with pytest.raises(error_cls) as err:
            chain.produce_blinded_block(slot, reveal)
        return f"{type(err.value).__name__}: {err.value}"
    finally:
        relay.stop()


def pin_other(chain, relay):
    chain.builder_pubkey = b"\x99" * 48


def relay_down(chain, relay):
    relay.stop()


@pytest.mark.parametrize("setup,needle", [(pin_other, "unexpected relay key"),
                                          (relay_down, "builder get_header failed")])
def test_refusals_match_jax(setup, needle):
    jhs, phs = harnesses({}, validators=VALIDATORS)
    with jax_backend("fake"):
        expected = refusal(jhs, jbc, jh, JChainError, setup)
        got = refusal(phs, pbc, h, ChainError, setup)
    assert got == expected
    assert needle in got


def test_registrations_and_serde_match_jax():
    """A signed validator registration reaches each package's relay through
    its client; the signing roots, the bid's JSON and its decoding agree."""
    from lighthouse_tpu.consensus.genesis import interop_secret_key as j_key

    jhs, phs = harnesses({}, validators=VALIDATORS)
    out = []
    with jax_backend("fake"):
        for hs, bc_mod in ((jhs, jbc), (phs, pbc)):
            sk = j_key(0)
            pk = sk.public_key().to_bytes()
            reg = hs.types.ValidatorRegistrationV1(fee_recipient=b"\x11" * 20,
                                                   gas_limit=30_000_000,
                                                   timestamp=1_600_000_000, pubkey=pk)
            root = bc_mod.builder_signing_root(reg.hash_tree_root(), hs.spec)
            signed = hs.types.SignedValidatorRegistrationV1(message=reg,
                                                            signature=sk.sign(root).to_bytes())
            relay = bc_mod.MockRelay(hs.chain).start()
            try:
                bc_mod.BuilderHttpClient(relay.url).register_validators([signed])
                slot = hs.advance_slot()
                parent = bytes(hs.chain.state_at_slot(slot)[0]
                               .latest_execution_payload_header.block_hash)
                fork, bid = relay.build_bid(slot, parent)
                out.append((root, sorted(relay.registrations), fork,
                            bid.as_ssz_bytes(), to_json(bid) if bc_mod is pbc
                            else jserde.to_json(bid)))
            finally:
                relay.stop()
    assert out[0] == out[1]
    _, regs, fork, raw, as_json = out[1]
    assert len(regs) == 1
    back = container_from_json(phs.types.signed_builder_bid[fork], as_json)
    assert back.as_ssz_bytes() == raw
