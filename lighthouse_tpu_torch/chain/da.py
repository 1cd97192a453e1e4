"""Deneb data availability: blob sidecar verification + the availability
checker gating block import.

Equivalent of the reference's
``beacon_node/beacon_chain/src/blob_verification.rs`` (gossip sidecar
checks: index bound, header/block consistency, commitment inclusion proof,
KZG proof) and ``data_availability_checker.rs`` (514 LoC — blocks whose
commitments aren't yet backed by verified blobs wait in the checker; import
proceeds only on full availability).

KZG verification runs through the ``Kzg`` engine the chain owns — the
port's ``Kzg`` runs a batch of two or more blobs on the card by default
(``ops/kzg_device.py``: the MSMs and the two-pairing check on the CUDA Fq
kernels, under the device supervisor).

A copy of the JAX package's ``lighthouse_tpu/chain/da.py``.
"""

from __future__ import annotations

import threading

from ..timeout_lock import TimeoutLock
from typing import Dict, List, Optional, Tuple

from ..types import ssz as ssz_mod


class BlobError(Exception):
    pass


# -------------------------------------------------------- inclusion proofs


def _commitments_field_position(body_cls) -> int:
    return list(body_cls.fields).index("blob_kzg_commitments")


def compute_blob_inclusion_proof(body, index: int) -> List[bytes]:
    """Merkle branch proving ``body.blob_kzg_commitments[index]`` against
    ``hash_tree_root(body)`` (reference ``blob_sidecar.rs`` proof builder):
    list subtree siblings, the length mix-in, then the body field siblings."""
    list_type = body.fields["blob_kzg_commitments"]
    commitments = list(body.blob_kzg_commitments)
    if index >= len(commitments):
        raise BlobError(f"blob index {index} >= {len(commitments)} commitments")
    chunks = [list_type.elem.hash_tree_root(c) for c in commitments]
    proof = ssz_mod.merkle_branch(chunks, list_type.limit, index)
    proof.append(len(commitments).to_bytes(32, "little"))  # length mix-in
    field_roots = [
        ftype.hash_tree_root(getattr(body, name))
        for name, ftype in body.fields.items()
    ]
    field_pos = _commitments_field_position(type(body))
    limit = 1 << max(0, (len(field_roots) - 1).bit_length())
    proof.extend(ssz_mod.merkle_branch(field_roots, limit, field_pos))
    return proof


def verify_blob_inclusion_proof(sidecar, body_cls, max_commitments: int) -> bool:
    """Check the sidecar's commitment really is in the signed header's body
    (is_valid_merkle_branch against header.body_root)."""
    from ..consensus.per_block import is_valid_merkle_branch

    header = sidecar.signed_block_header.message
    depth_list = max(0, (max_commitments - 1).bit_length())
    n_fields = len(body_cls.fields)
    depth_body = max(0, (n_fields - 1).bit_length())
    depth = depth_list + 1 + depth_body
    field_pos = _commitments_field_position(body_cls)
    # generalized position: field subtree -> left (list body) -> leaf index
    gindex = (field_pos << (depth_list + 1)) + int(sidecar.index)
    leaf = ssz_mod.bytes48.hash_tree_root(bytes(sidecar.kzg_commitment))
    return is_valid_merkle_branch(
        leaf,
        [bytes(b) for b in sidecar.kzg_commitment_inclusion_proof],
        depth,
        gindex,
        bytes(header.body_root),
    )


# ----------------------------------------------------------- gossip checks


def verify_blob_sidecar(sidecar, *, spec, types, kzg=None,
                        verify_kzg: bool = True,
                        header_verifier=None,
                        current_slot: Optional[int] = None) -> bytes:
    """Gossip-rule verification for one sidecar; returns the block root it
    attests to (blob_verification.rs ``GossipVerifiedBlob``).

    ``header_verifier(signed_block_header) -> bool`` authenticates the
    proposer signature (the chain provides it on the gossip path — a forged
    header must never be stored or re-forwarded); ``current_slot`` bounds
    far-future slots out of the cache."""
    header = sidecar.signed_block_header.message
    if int(sidecar.index) >= spec.preset.max_blob_commitments_per_block:
        raise BlobError(f"blob index {sidecar.index} out of range")
    if current_slot is not None and int(header.slot) > current_slot + 1:
        raise BlobError(f"sidecar slot {header.slot} is in the future")
    fork = spec.fork_name_at_slot(int(header.slot))
    body_cls = types.block_body.get(fork) or types.block_body["deneb"]
    if not verify_blob_inclusion_proof(
        sidecar, body_cls, spec.preset.max_blob_commitments_per_block
    ):
        raise BlobError("commitment inclusion proof invalid")
    if header_verifier is not None:
        if not header_verifier(sidecar.signed_block_header):
            raise BlobError("header proposer signature invalid")
    if verify_kzg:
        if kzg is None:
            raise BlobError("no KZG engine configured")
        if not kzg.verify_blob_kzg_proof(
            bytes(sidecar.blob), bytes(sidecar.kzg_commitment),
            bytes(sidecar.kzg_proof),
        ):
            raise BlobError("KZG proof invalid")
    return header.hash_tree_root()


# ------------------------------------------------------------- the checker


class DataAvailabilityChecker:
    """Blocks wait here until all their committed blobs arrive verified
    (data_availability_checker.rs).  Thread-safe; pruned by slot; both stores
    are hard-capped so unauthenticated input can't grow them without bound."""

    MAX_PENDING_BLOCKS = 64
    MAX_BLOB_ROOTS = 512

    def __init__(self, *, spec, types, kzg=None, header_verifier=None,
                 slot_provider=None):
        self.spec = spec
        self.types = types
        self.kzg = kzg
        # chain-provided proposer-signature check + clock (gossip path)
        self.header_verifier = header_verifier
        self.slot_provider = slot_provider
        self._lock = TimeoutLock("da_checker")
        # block_root -> {index: sidecar} (KZG-verified)
        self._blobs: Dict[bytes, Dict[int, object]] = {}
        # block_root -> signed block awaiting availability
        self._pending_blocks: Dict[bytes, object] = {}

    # ------------------------------------------------------------- blobs

    def put_blob(self, sidecar, verified: bool = False) -> bytes:
        """Verify (unless already ``verified``) + store one sidecar; returns
        its block root."""
        if verified:
            block_root = sidecar.signed_block_header.message.hash_tree_root()
        else:
            block_root = verify_blob_sidecar(
                sidecar, spec=self.spec, types=self.types, kzg=self.kzg,
                header_verifier=self.header_verifier,
                current_slot=self.slot_provider() if self.slot_provider else None,
            )
        with self._lock:
            if (
                block_root not in self._blobs
                and len(self._blobs) >= self.MAX_BLOB_ROOTS
            ):
                # evict the oldest-slot entry (bounded-cache discipline)
                oldest = min(
                    self._blobs,
                    key=lambda r: int(
                        next(iter(self._blobs[r].values())).signed_block_header.message.slot
                    ),
                )
                del self._blobs[oldest]
            self._blobs.setdefault(block_root, {})[int(sidecar.index)] = sidecar
        return block_root

    def blobs_for(self, block_root: bytes) -> Dict[int, object]:
        with self._lock:
            return dict(self._blobs.get(block_root, {}))

    # ------------------------------------------------------------ checking

    def check_availability(self, signed_block,
                           sidecars: Optional[List] = None) -> Tuple[str, List]:
        """('available', sidecars-in-order) when every commitment is backed
        by a verified blob; ('pending', missing-indices) otherwise.  Extra
        ``sidecars`` supplied by the caller (RPC, API) are verified+absorbed.
        Batch-verifies the supplied sidecars' KZG proofs in ONE engine call
        (kzg_utils.rs:23-36)."""
        block = signed_block.message
        commitments = [bytes(c) for c in getattr(block.body, "blob_kzg_commitments", [])]
        if not commitments:
            return "available", []
        block_root = block.hash_tree_root()
        if sidecars:
            self._absorb_batch(block_root, block, sidecars)
        have = self.blobs_for(block_root)
        missing = [i for i in range(len(commitments)) if i not in have]
        if missing:
            return "pending", missing
        ordered = []
        for i, commitment in enumerate(commitments):
            sc = have[i]
            if bytes(sc.kzg_commitment) != commitment:
                raise BlobError(f"blob {i} commitment mismatch with block")
            ordered.append(sc)
        return "available", ordered

    def _absorb_batch(self, block_root: bytes, block, sidecars: List) -> None:
        """Verify caller-supplied sidecars as one KZG batch + per-sidecar
        structural checks, then store them."""
        fresh = []
        have = self.blobs_for(block_root)
        for sc in sidecars:
            if int(sc.index) in have:
                continue
            header = sc.signed_block_header.message
            if header.hash_tree_root() != block_root:
                raise BlobError("sidecar header does not match block")
            fork = self.spec.fork_name_at_slot(int(header.slot))
            body_cls = self.types.block_body.get(fork) or self.types.block_body["deneb"]
            if not verify_blob_inclusion_proof(
                sc, body_cls, self.spec.preset.max_blob_commitments_per_block
            ):
                raise BlobError(f"blob {sc.index} inclusion proof invalid")
            fresh.append(sc)
        if not fresh:
            return
        if self.kzg is not None:
            ok = self.kzg.verify_blob_kzg_proof_batch(
                [bytes(sc.blob) for sc in fresh],
                [bytes(sc.kzg_commitment) for sc in fresh],
                [bytes(sc.kzg_proof) for sc in fresh],
            )
            if not ok:
                raise BlobError("blob KZG batch verification failed")
        with self._lock:
            slot_map = self._blobs.setdefault(block_root, {})
            for sc in fresh:
                slot_map[int(sc.index)] = sc

    # ------------------------------------------------------ pending blocks

    def put_pending_block(self, signed_block) -> None:
        with self._lock:
            if len(self._pending_blocks) >= self.MAX_PENDING_BLOCKS:
                oldest = min(
                    self._pending_blocks,
                    key=lambda r: int(self._pending_blocks[r].message.slot),
                )
                del self._pending_blocks[oldest]
            self._pending_blocks[signed_block.message.hash_tree_root()] = signed_block

    def take_ready_block(self, block_root: bytes):
        """Pop the pending block at ``block_root`` if its blobs are now all
        present; None otherwise."""
        with self._lock:
            block = self._pending_blocks.get(block_root)
        if block is None:
            return None
        status, _ = self.check_availability(block)
        if status != "available":
            return None
        with self._lock:
            return self._pending_blocks.pop(block_root, None)

    # ------------------------------------------------------------- pruning

    def prune(self, finalized_slot: int) -> None:
        with self._lock:
            for root in [
                r for r, m in self._blobs.items()
                if m and int(next(iter(m.values())).signed_block_header.message.slot)
                < finalized_slot
            ]:
                del self._blobs[root]
            for root in [
                r for r, b in self._pending_blocks.items()
                if int(b.message.slot) < finalized_slot
            ]:
                del self._pending_blocks[root]
