"""Backfill sync: fill history BEHIND a checkpoint anchor, newest-first.

Equivalent of the reference's ``network/src/sync/backfill_sync/mod.rs``
(1,201 LoC): after a checkpoint boot the chain runs forward from the anchor;
backfill walks BlocksByRange batches backwards, authenticating each block by
hash linkage to the anchor (``block.parent_root`` chains are as strong as
the weak-subjectivity root itself), and persists them to the store so the
node can serve history.

A copy of the JAX package's ``lighthouse_tpu/network/backfill.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..metrics import BACKFILL_BATCH_RETRIES
from . import rpc as rpc_mod
from .peer_manager import PeerAction
from .sync import decode_signed_block

BATCH_SLOTS = 32
REQUEST_TIMEOUT_S = 10.0


class BackfillSync:
    def __init__(self, *, chain, service):
        self.chain = chain
        self.service = service
        # The backfill frontier: the oldest block we hold and its parent.
        anchor = chain.get_block(chain.genesis_block_root)
        if anchor is not None:
            self.oldest_slot = int(anchor.message.slot)
            self.expected_parent = bytes(anchor.message.parent_root)
        else:
            self.oldest_slot = 0  # genesis boot: nothing to backfill
            self.expected_parent = b"\x00" * 32
        self.blocks_filled = 0

    @property
    def complete(self) -> bool:
        return self.oldest_slot <= 1 or self.expected_parent == b"\x00" * 32

    def backfill_from(self, peer: str, target_slot: int = 0, *,
                      request_timeout: float = REQUEST_TIMEOUT_S,
                      fallback_peers: Sequence[str] = ()) -> int:
        """Pull batches from ``peer`` until history reaches ``target_slot``
        (or the peer runs dry).  Returns #blocks persisted.

        Every batch request carries ``request_timeout``; a batch that fails
        (dead peer, RPC timeout) is retried ONCE against the next peer in
        ``fallback_peers`` (``backfill_batch_retries_total{outcome}``) —
        a single dead peer bounds the stall to one timeout instead of
        parking backfill forever (the churn scenarios kill the serving
        peer mid-backfill to prove exactly this)."""
        chain = self.chain
        filled = 0
        candidates = [peer] + [p for p in fallback_peers if p != peer]
        while not self.complete and self.oldest_slot > target_slot:
            start = max(target_slot, self.oldest_slot - BATCH_SLOTS)
            count = self.oldest_slot - start
            request = rpc_mod.BlocksByRangeRequest(start_slot=start, count=count)
            chunks = None
            self_limited = False
            failed: List[str] = []
            for attempt, serving in enumerate(candidates[:2]):
                try:
                    chunks = self.service.request(
                        serving, rpc_mod.BLOCKS_BY_RANGE, request,
                        timeout=request_timeout,
                    )
                except rpc_mod.RpcSelfLimited:
                    self_limited = True  # OUR throttle: resume later, no blame
                    break
                except rpc_mod.RpcError:
                    self.service.peer_manager.report(
                        serving, PeerAction.MID_TOLERANCE, "backfill rpc failed"
                    )
                    failed.append(serving)
                    if attempt == 0 and len(candidates) > 1:
                        BACKFILL_BATCH_RETRIES.inc(outcome="retried")
                        continue  # one retry, against a DIFFERENT peer
                    break
                if attempt > 0:
                    BACKFILL_BATCH_RETRIES.inc(outcome="recovered")
                peer = serving
                # future batches: the answering peer first, proven-dead
                # peers demoted LAST (a later failure must fall back to a
                # still-untried peer, not straight back to the dead one)
                candidates = ([serving]
                              + [p for p in candidates
                                 if p != serving and p not in failed]
                              + failed)
                break
            if chunks is None:
                if not self_limited and len(candidates) > 1:
                    BACKFILL_BATCH_RETRIES.inc(outcome="exhausted")
                break
            blocks = []
            for result, payload, _ctx in chunks:
                if result != rpc_mod.SUCCESS:
                    continue
                try:
                    blocks.append(decode_signed_block(chain, payload))
                except Exception:
                    self.service.peer_manager.report(
                        peer, PeerAction.LOW_TOLERANCE, "undecodable backfill block"
                    )
                    return filled
            if not blocks:
                break  # peer has nothing older (or pruned history)
            progressed = False
            # Walk newest->oldest verifying the parent-hash chain into the
            # frontier (backfill's authenticity comes from this linkage).
            for signed in sorted(blocks, key=lambda b: -int(b.message.slot)):
                root = signed.message.hash_tree_root()
                if root != self.expected_parent:
                    self.service.peer_manager.report(
                        peer, PeerAction.LOW_TOLERANCE,
                        "backfill block breaks the hash chain",
                    )
                    return filled
                chain.db.put_block(root, signed)
                self._backfill_blobs(peer, root, signed)
                self.expected_parent = bytes(signed.message.parent_root)
                self.oldest_slot = int(signed.message.slot)
                filled += 1
                self.blocks_filled += 1
                progressed = True
                if self.complete:
                    break
            if not progressed:
                break
        return filled

    def _backfill_blobs(self, peer: str, block_root: bytes, signed) -> None:
        """Fetch sidecars for a hash-chain-verified backfilled block inside
        the blob retention window (reference: backfill requests blobs
        alongside blocks post-Deneb).  Verification and persistence live at
        the chain layer (``store_backfilled_blobs``: exact index coverage,
        commitment equality against the verified block, KZG batch proof)."""
        chain = self.chain
        commitments = getattr(signed.message.body, "blob_kzg_commitments", None)
        if not commitments:
            return
        horizon = chain.current_slot() - (
            chain.spec.min_epochs_for_blob_sidecars_requests
            * chain.spec.slots_per_epoch
        )
        if int(signed.message.slot) < horizon:
            return  # outside retention: blocks only (spec behavior)
        try:
            chunks = self.service.request(
                peer, rpc_mod.BLOBS_BY_ROOT,
                rpc_mod.BlobsByRootRequest(
                    ids=[(block_root, i) for i in range(len(commitments))]
                ),
                timeout=10.0,
            )
        except rpc_mod.RpcSelfLimited:
            return  # OUR outbound throttle, not the peer's failure
        except rpc_mod.RpcError:
            self.service.peer_manager.report(
                peer, PeerAction.HIGH_TOLERANCE, "backfill blobs unavailable"
            )
            return
        sidecars = []
        for result, payload, _ctx in chunks:
            if result != rpc_mod.SUCCESS:
                continue
            try:
                sidecars.append(chain.types.BlobSidecar.from_ssz_bytes(payload))
            except Exception:
                self.service.peer_manager.report(
                    peer, PeerAction.LOW_TOLERANCE, "undecodable backfill sidecar"
                )
                return
        from ..chain.beacon_chain import BlockError

        try:
            # chain-layer verification: exact index coverage, commitment
            # equality, KZG batch proof; persisted in the DB where retention
            # pruning governs it
            chain.store_backfilled_blobs(signed, sidecars)
        except BlockError as e:
            # incomplete or invalid: penalize and leave unstored so another
            # peer can be asked (re-running backfill re-requests this span)
            self.service.peer_manager.report(
                peer, PeerAction.MID_TOLERANCE, f"backfill blobs rejected: {e}"
            )
