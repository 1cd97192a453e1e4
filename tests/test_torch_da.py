"""The port's data availability (``chain/da.py``) vs the JAX package's.

``lighthouse_tpu_torch.chain.da`` copies the JAX package's ``chain/da.py``;
it runs on the port's ``Kzg``, which verifies a batch of two or more blobs
on the card by default: here ``Kzg(setup, device="cpu")`` (the device
program on the CUDA kernels' plain versions) on a width-64 blob preset and
the insecure dev setup, as the JAX package's ``test_device_chain.py``
does.  Every comparison is exact:

- both packages' harness chains with blobs (the same dev setup, fake
  crypto, the same user graffiti) produce the same blocks and the same
  sidecars byte for byte (commitments, proofs, inclusion proofs), and
  import them through ``process_block_with_blobs`` to the same head and
  the same stored sidecars;
- ``compute_blob_inclusion_proof`` gives the JAX package's branch for
  every commitment of a mainnet Deneb body;
- ``workload.blob_sidecars`` (``[chain]``'s sidecars): a block import case
  with given commitments differs from the case without them only in its
  commitments and blob gas, and its sidecars carry the block's header and
  signature and inclusion proofs that verify against it;
- the JAX package's ``test_da.py`` cases that need no ``network/``
  re-pointed at the port.
"""

import dataclasses

import pytest

pytest.importorskip("jax")

from lighthouse_tpu.chain.da import compute_blob_inclusion_proof as j_inclusion_proof  # noqa: E402
from lighthouse_tpu.crypto.kzg.kzg import Kzg as JKzg  # noqa: E402
from lighthouse_tpu.crypto.kzg.kzg import TrustedSetup as JTrustedSetup  # noqa: E402
from lighthouse_tpu.types.containers import build_types as j_build_types  # noqa: E402
from lighthouse_tpu.types.spec import MAINNET_PRESET as J_MAINNET_PRESET  # noqa: E402
from lighthouse_tpu_torch import workload  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.chain.beacon_chain import BlockError  # noqa: E402
from lighthouse_tpu_torch.chain.da import (  # noqa: E402
    BlobError,
    compute_blob_inclusion_proof,
    verify_blob_inclusion_proof,
)
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.crypto.kzg.kzg import Kzg, TrustedSetup  # noqa: E402
from lighthouse_tpu_torch.types.spec import MINIMAL_PRESET, minimal_spec  # noqa: E402
from test_torch_chain import (  # noqa: E402,F401
    GRAFFITI,
    harnesses,
    jax_backend,
    one_torch_thread,
    port_cpu,
)

WIDTH = 64  # small blobs: 64 field elements = 2 KiB, fast host math
PRESET = dataclasses.replace(MINIMAL_PRESET, field_elements_per_blob=WIDTH)
DENEB = dict(preset=PRESET, altair_fork_epoch=0, bellatrix_fork_epoch=0,
             capella_fork_epoch=0, deneb_fork_epoch=0)


def _blob(i: int) -> bytes:
    return b"".join(((i * WIDTH + j) % 251).to_bytes(32, "big") for j in range(WIDTH))


@pytest.fixture(scope="module")
def setup():
    return TrustedSetup.insecure_dev_setup(width=WIDTH)


@pytest.fixture()
def harness(setup):
    set_backend("fake")
    spec = minimal_spec(**DENEB)
    return BeaconChainHarness(
        validator_count=16, spec=spec, fake_crypto=True, kzg=Kzg(setup, device="cpu")
    )


def test_blob_chain_matches_jax(setup):
    """Both packages' harnesses produce the same blob-carrying blocks and
    sidecars and import them to the same head and stored sidecars."""
    j_setup = JTrustedSetup.insecure_dev_setup(width=WIDTH)
    jhs, phs = harnesses(DENEB, validators=16)
    jhs.chain.kzg, phs.chain.kzg = JKzg(j_setup), Kzg(setup, device="cpu")
    jhs.chain.da_checker.kzg, phs.chain.da_checker.kzg = jhs.chain.kzg, phs.chain.kzg
    for k in range(3):
        blobs = [_blob(3 * k + i) for i in range(k + 1)]
        with jax_backend("fake"):
            jhs.advance_slot()
            j_signed, j_sidecars = jhs.produce_signed_block_with_blobs(blobs)
            j_root = jhs.chain.process_block_with_blobs(j_signed, j_sidecars)
        phs.advance_slot()
        p_signed, p_sidecars = phs.produce_signed_block_with_blobs(blobs)
        assert p_signed.as_ssz_bytes() == j_signed.as_ssz_bytes()
        assert [s.as_ssz_bytes() for s in p_sidecars] == [s.as_ssz_bytes() for s in j_sidecars]
        assert phs.chain.process_block_with_blobs(p_signed, p_sidecars) == j_root
        assert phs.chain.head_root == jhs.chain.head_root
        assert [s.as_ssz_bytes() for s in phs.chain.get_blobs(j_root)] == [
            s.as_ssz_bytes() for s in jhs.chain.get_blobs(j_root)]
    assert bytes(p_signed.message.body.graffiti) == GRAFFITI


def test_mainnet_inclusion_proofs_match_jax():
    """Every commitment's branch of a mainnet Deneb body (six commitments)
    equals the JAX package's and verifies against the body root."""
    case = workload.block_import_case(4096, seed=0xDA)
    body = case.signed_block.message.body
    j_types = j_build_types(J_MAINNET_PRESET)
    j_body = j_types.block_body["deneb"].from_ssz_bytes(body.as_ssz_bytes())
    max_c = case.spec.preset.max_blob_commitments_per_block
    sidecars = workload.blob_sidecars(case, [bytes(131072)] * 6, [bytes(48)] * 6)
    for i in range(6):
        proof = compute_blob_inclusion_proof(body, i)
        assert proof == j_inclusion_proof(j_body, i)
        assert [bytes(b) for b in sidecars[i].kzg_commitment_inclusion_proof] == proof
        assert verify_blob_inclusion_proof(sidecars[i], type(body), max_c)


def test_blob_sidecars_of_block_case():
    """``block_import_case`` with given commitments changes only the
    commitments and the blob gas; ``blob_sidecars`` carries the block's
    header and signature, and the header's signature is the proposer's
    over the block's root."""
    from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.chain.slot_clock import ManualSlotClock

    plain = workload.block_import_case(4096, seed=0xDA)
    given = list(plain.keys.points)[:2]
    case = workload.block_import_case(4096, seed=0xDA, blob_commitments=given)
    a, b = plain.signed_block.message.body, case.signed_block.message.body
    for name in a.fields:
        if name == "blob_kzg_commitments":
            assert [bytes(c) for c in getattr(b, name)] == given
        elif name == "execution_payload":
            pa, pb = getattr(a, name), getattr(b, name)
            for field in pa.fields:
                if field != "blob_gas_used":
                    assert getattr(pb, field) == getattr(pa, field), field
            assert int(pb.blob_gas_used) == 2 * 131072
        else:
            assert getattr(b, name) == getattr(a, name), name
    sidecars = workload.blob_sidecars(case, [bytes(131072)] * 2, [bytes(48)] * 2)
    block = case.signed_block.message
    workload.warm_pubkey_cache(case.keys)
    anchor = case.pre_state
    clock = ManualSlotClock(int(anchor.genesis_time), case.spec.seconds_per_slot)
    clock.set_slot(int(block.slot))
    chain = BeaconChain(genesis_state=anchor, types=case.types, spec=case.spec, slot_clock=clock)
    for i, sc in enumerate(sidecars):
        header = sc.signed_block_header
        assert int(sc.index) == i and header.message.hash_tree_root() == block.hash_tree_root()
        assert bytes(header.signature) == bytes(case.signed_block.signature)
    assert chain.verify_block_header_signature(sidecars[0].signed_block_header)
    with pytest.raises(ValueError):
        workload.blob_sidecars(case, [bytes(131072)], [bytes(48)])


# ------------------------------------- the JAX package's DA tests, re-pointed


def test_inclusion_proof_roundtrip(harness):
    harness.advance_slot()
    signed, sidecars = harness.produce_signed_block_with_blobs([_blob(0), _blob(1)])
    body_cls = harness.types.block_body["deneb"]
    maxc = harness.spec.preset.max_blob_commitments_per_block
    for sc in sidecars:
        assert verify_blob_inclusion_proof(sc, body_cls, maxc)
    # tampered commitment fails the proof
    bad = harness.types.BlobSidecar(
        index=sidecars[0].index,
        blob=sidecars[0].blob,
        kzg_commitment=b"\xaa" * 48,
        kzg_proof=sidecars[0].kzg_proof,
        signed_block_header=sidecars[0].signed_block_header,
        kzg_commitment_inclusion_proof=sidecars[0].kzg_commitment_inclusion_proof,
    )
    assert not verify_blob_inclusion_proof(bad, body_cls, maxc)


def test_import_gated_on_availability(harness):
    harness.advance_slot()
    signed, sidecars = harness.produce_signed_block_with_blobs([_blob(2), _blob(3)])
    chain = harness.chain
    # without blobs: import refuses and stashes the block
    with pytest.raises(BlockError, match="pending availability"):
        chain.process_block(signed)
    # with blobs: imports, stores sidecars
    root = chain.process_block_with_blobs(signed, sidecars)
    assert chain.head_root == root
    stored = chain.get_blobs(root)
    assert [int(s.index) for s in stored] == [0, 1]


def test_bad_kzg_proof_rejected(harness):
    harness.advance_slot()
    signed, sidecars = harness.produce_signed_block_with_blobs([_blob(4), _blob(5)])
    tampered = harness.types.BlobSidecar(
        index=sidecars[1].index,
        blob=sidecars[1].blob,
        kzg_commitment=sidecars[1].kzg_commitment,
        kzg_proof=sidecars[0].kzg_proof,  # wrong proof
        signed_block_header=sidecars[1].signed_block_header,
        kzg_commitment_inclusion_proof=sidecars[1].kzg_commitment_inclusion_proof,
    )
    with pytest.raises(BlockError, match="blob verification failed"):
        harness.chain.process_block_with_blobs(signed, [sidecars[0], tampered])


def test_commitment_mismatch_rejected(harness):
    """Sidecars from a different block must not satisfy availability."""
    harness.advance_slot()
    signed, sidecars = harness.produce_signed_block_with_blobs([_blob(6)])
    other = harness.chain.types.BlobSidecar(
        index=0,
        blob=_blob(7),
        kzg_commitment=harness.chain.kzg.blob_to_kzg_commitment(_blob(7)),
        kzg_proof=sidecars[0].kzg_proof,
        signed_block_header=sidecars[0].signed_block_header,
        kzg_commitment_inclusion_proof=sidecars[0].kzg_commitment_inclusion_proof,
    )
    with pytest.raises(BlockError):
        harness.chain.process_block_with_blobs(signed, [other])


def test_forged_header_sidecar_rejected(setup):
    """A sidecar whose header carries a forged proposer signature must be
    refused before it enters the DA cache (real BLS; review finding)."""
    from lighthouse_tpu_torch.chain.da import BlobError

    spec = minimal_spec(
        preset=PRESET,
        altair_fork_epoch=0, bellatrix_fork_epoch=0,
        capella_fork_epoch=0, deneb_fork_epoch=0,
    )
    hs = BeaconChainHarness(
        validator_count=16, spec=spec, fake_crypto=False, kzg=Kzg(setup, device="cpu")
    )
    hs.advance_slot()
    signed, sidecars = hs.produce_signed_block_with_blobs([_blob(10)])
    # legit sidecar verifies
    hs.chain.da_checker.put_blob(sidecars[0])
    # forge: same header content, signature swapped for a valid-but-wrong one
    other_sig = hs.keys[0].sign(b"not the header").to_bytes()
    forged = hs.types.BlobSidecar(
        index=0,
        blob=sidecars[0].blob,
        kzg_commitment=sidecars[0].kzg_commitment,
        kzg_proof=sidecars[0].kzg_proof,
        signed_block_header=hs.types.SignedBeaconBlockHeader(
            message=sidecars[0].signed_block_header.message.copy(),
            signature=other_sig,
        ),
        kzg_commitment_inclusion_proof=sidecars[0].kzg_commitment_inclusion_proof,
    )
    with pytest.raises(BlobError, match="proposer signature"):
        hs.chain.da_checker.put_blob(forged)


def test_device_kzg_batch_matches_host(setup):
    """The fused device MSM+pairing program agrees with the host golden model
    on valid and tampered batches."""
    host = Kzg(setup, device=None)
    dev = Kzg(setup, device="cpu")
    blobs = [_blob(i) for i in range(3)]
    comms = [host.blob_to_kzg_commitment(b) for b in blobs]
    proofs = [host.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, comms)]
    assert host.verify_blob_kzg_proof_batch(blobs, comms, proofs)
    assert dev.verify_blob_kzg_proof_batch(blobs, comms, proofs)
    bad = [proofs[1], proofs[0], proofs[2]]
    assert not host.verify_blob_kzg_proof_batch(blobs, comms, bad)
    assert not dev.verify_blob_kzg_proof_batch(blobs, comms, bad)


def test_device_kzg_batch_is_supervised(setup):
    """ISSUE 10 host-sync fix: the kzg device leg runs under the device
    supervisor — a faulted dispatch resolves through the host golden model
    (correct verdicts, one fallback counter), and a tripped breaker routes
    subsequent batches straight to the host."""
    from lighthouse_tpu_torch import device_supervisor as ds
    from lighthouse_tpu_torch import fault_injection as fi

    fi.reset_for_tests()
    ds.reset_for_tests()
    try:
        dev = Kzg(setup, device="cpu")
        blobs = [_blob(i) for i in range(2)]
        comms = [dev.blob_to_kzg_commitment(b) for b in blobs]
        proofs = [dev.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, comms)]

        fi.install("device.dispatch", "error", op="kzg_batch")
        # valid and tampered batches both decide CORRECTLY on the host path
        assert dev.verify_blob_kzg_proof_batch(blobs, comms, proofs)
        bad = [proofs[1], proofs[0]]
        assert not dev.verify_blob_kzg_proof_batch(blobs, comms, bad)
        # third failure trips the breaker (default threshold 3) — batches
        # now route to host without touching the device
        assert dev.verify_blob_kzg_proof_batch(blobs, comms, proofs)
        assert ds.breaker_state("kzg_batch") == "open"
        assert dev.verify_blob_kzg_proof_batch(blobs, comms, proofs)
        # device recovers once faults clear and the cooldown elapses
        fi.reset_for_tests()
        ds.SUPERVISOR.breaker("kzg_batch")._opened_at = 0.0
        assert dev.verify_blob_kzg_proof_batch(blobs, comms, proofs)
        assert ds.breaker_state("kzg_batch") in ("half_open", "closed")
    finally:
        fi.reset_for_tests()
        ds.reset_for_tests()


