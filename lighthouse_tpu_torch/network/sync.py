"""Sync manager: range sync + parent (single-block) lookups.

Equivalent of the reference's ``network/src/sync/manager.rs`` (doc ``:1-35``)
with ``range_sync/`` (forward sync in epoch batches from a peer ahead of us)
and ``block_lookups/`` (fetch unknown parents by root, import the chain in
order).  Backfill (checkpoint→genesis) arrives with checkpoint sync.

A copy of the JAX package's ``lighthouse_tpu/network/sync.py``.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional

from ..chain.beacon_chain import BlockError
from ..logs import get_logger
from ..metrics import SYNC_LOOKUP_ABORTED
from . import rpc as rpc_mod
from .peer_manager import PeerAction

log = get_logger("network.sync")

BATCH_SLOTS = 16  # 2 epochs on the minimal preset (reference: 2-epoch batches)
PARENT_DEPTH_LIMIT = 32  # reference ``block_lookups`` parent chain bound


def _lookup_aborted(reason: str) -> None:
    """One counter for every path that gives up on a lookup before import —
    the churn scenarios' evidence that a dead/lying peer bounded the chase
    instead of stalling it (``sync_lookup_aborted_total{reason}``)."""
    SYNC_LOOKUP_ABORTED.inc(reason=reason)


class SyncState:
    SYNCED = "synced"
    SYNCING = "syncing"


def decode_signed_block(chain, payload: bytes):
    """Decode a SignedBeaconBlock of unknown fork from SSZ bytes.

    The container is variable-size: bytes 0..4 are the offset of ``message``
    (past the 96-byte signature); the message's first field is the slot,
    which selects the fork's container class."""
    (message_off,) = struct.unpack_from("<I", payload, 0)
    slot = struct.unpack_from("<Q", payload, message_off)[0]
    fork = chain.spec.fork_name_at_slot(slot)
    return chain.types.signed_block[fork].from_ssz_bytes(payload)


class SyncManager:
    def __init__(self, *, chain, service, router):
        self.chain = chain
        self.service = service
        self.router = router
        router.sync = self
        self.state = SyncState.SYNCED
        self._lock = threading.Lock()
        self._sync_thread: Optional[threading.Thread] = None
        self._lookups_in_flight: set = set()

    def busy(self) -> bool:
        """True while range sync or any single-block lookup is in flight —
        the simulator's quiescence check (``Simulator.settle``) must not
        call a fabric settled while a background chase is still importing
        blocks."""
        with self._lock:
            if self._lookups_in_flight:
                return True
            return (self._sync_thread is not None
                    and self._sync_thread.is_alive())

    # ------------------------------------------------------------- status

    def on_peer_status(self, peer: str, status: rpc_mod.Status) -> None:
        """A peer ahead of our head triggers range sync
        (reference ``manager.rs`` ``add_peer`` → RangeSync)."""
        local_head_slot = self.chain._blocks_slot(self.chain.head_root)
        if status.head_slot <= local_head_slot:
            return
        if status.head_root and self.chain.fork_choice.contains_block(status.head_root):
            return
        with self._lock:
            if self._sync_thread is not None and self._sync_thread.is_alive():
                return
            self.state = SyncState.SYNCING
            self._sync_thread = threading.Thread(
                target=self._range_sync, args=(peer, status), daemon=True,
                name=f"range-sync-{self.service.peer_id}",
            )
            self._sync_thread.start()

    # --------------------------------------------------------- range sync

    def _decode_block_chunk(self, payload: bytes):
        return decode_signed_block(self.chain, payload)

    def _range_sync(self, peer: str, status: rpc_mod.Status) -> None:
        chain = self.chain
        log.info("range sync started", peer=peer,
                 from_slot=chain._blocks_slot(chain.head_root),
                 target_slot=int(status.head_slot))
        try:
            prev_start = -1
            while True:
                start = chain._blocks_slot(chain.head_root) + 1
                if start > status.head_slot:
                    break
                log.debug("range sync batch", peer=peer, start_slot=start,
                          target_slot=int(status.head_slot))
                if start == prev_start:
                    # No head progress over a full batch (e.g. the peer keeps
                    # serving a fork our fork choice doesn't prefer): stop
                    # rather than livelock re-requesting the same span.
                    break
                prev_start = start
                try:
                    chunks = self.service.request(
                        peer,
                        rpc_mod.BLOCKS_BY_RANGE,
                        rpc_mod.BlocksByRangeRequest(start_slot=start, count=BATCH_SLOTS),
                        timeout=10.0,
                    )
                except rpc_mod.RpcSelfLimited:
                    break  # OUR outbound throttle: retry next round, no blame
                except rpc_mod.RpcError:
                    self.service.peer_manager.report(peer, PeerAction.MID_TOLERANCE, "sync rpc failed")
                    break
                if not chunks:
                    break  # peer had nothing for the span: caught up or lying
                for result, payload, _ctx in chunks:
                    if result != rpc_mod.SUCCESS:
                        continue
                    try:
                        signed = self._decode_block_chunk(payload)
                        self._import_with_blobs(peer, signed)
                        self.router._publish_light_client_updates()
                    except BlockError as e:
                        # Narrower than _TRANSIENT_BLOCK_ERRORS on purpose:
                        # the bare "blob" fragment there would also excuse a
                        # peer that fails to serve sidecars for its OWN
                        # blocks — that stays penalized.  Self-limited blob
                        # fetches match "pending availability".
                        if any(t in str(e) for t in
                               ("future slot", "pending availability",
                                "unknown parent")):
                            return  # not the peer's fault (incl. OUR throttle)
                        self.service.peer_manager.report(
                            peer, PeerAction.LOW_TOLERANCE, f"bad sync block: {e}"
                        )
                        return
        finally:
            self.state = SyncState.SYNCED
            log.info("range sync finished", peer=peer,
                     head_slot=chain._blocks_slot(chain.head_root))

    def _import_with_blobs(self, peer: str, signed) -> None:
        """Import a synced block, fetching its blob sidecars over
        BlobsByRoot first when the body carries commitments (reference
        ``network_context.rs`` block+blob coupling)."""
        chain = self.chain
        commitments = getattr(signed.message.body, "blob_kzg_commitments", None)
        if not commitments:
            chain.process_block(signed)
            return
        block_root = signed.message.hash_tree_root()
        ids = [(block_root, i) for i in range(len(commitments))]
        try:
            chunks = self.service.request(
                peer, rpc_mod.BLOBS_BY_ROOT,
                rpc_mod.BlobsByRootRequest(ids=ids), timeout=10.0,
            )
        except rpc_mod.RpcSelfLimited:
            raise BlockError("pending availability: blob fetch self-limited")
        except rpc_mod.RpcError as e:
            raise BlockError(f"peer did not serve blobs: {e}") from e
        sidecars = []
        for result, payload, _ctx in chunks:
            if result != rpc_mod.SUCCESS:
                continue
            try:
                sidecars.append(chain.types.BlobSidecar.from_ssz_bytes(payload))
            except Exception as e:
                raise BlockError(f"undecodable blob sidecar: {e}") from e
        chain.process_block_with_blobs(signed, sidecars)

    # ------------------------------------------------- single-block lookup

    # BlockError fragments that are TRANSIENT or PEER-ATTRIBUTABLE: the
    # block may import fine later (clock skew, ancestry still fetching) or
    # a different peer may serve good sidecars ("blob" covers missing /
    # undecodable / unverifiable sidecars — blob faults belong to the
    # serving peer, not the root).  None of these may poison the root as
    # pre-finalization.
    _TRANSIENT_BLOCK_ERRORS = ("future slot", "pending availability",
                               "unknown parent", "blob")
    MAX_CONCURRENT_LOOKUPS = 8

    def lookup_block(self, block_root: bytes, peer: str) -> None:
        """Fetch one unknown block by root (attestation-triggered single
        block lookup, reference ``block_lookups/single_block_lookup.rs``) and
        import it.  Only a root-verified block that PERMANENTLY fails import
        is remembered as rejected — a transient failure or a peer serving
        the wrong bytes must not let an attacker poison an honest root."""
        chain = self.chain
        block_root = bytes(block_root)
        try:
            if chain.fork_choice.contains_block(block_root):
                return
            try:
                chunks = self.service.request(
                    peer,
                    rpc_mod.BLOCKS_BY_ROOT,
                    rpc_mod.BlocksByRootRequest(roots=[block_root]),
                    timeout=5.0,
                )
            except rpc_mod.RpcError:
                _lookup_aborted("rpc_error")
                return
            got = [c for c in chunks if c[0] == rpc_mod.SUCCESS]
            if not got:
                _lookup_aborted("not_found")
                return  # peer doesn't have it either: learn nothing
            try:
                signed = self._decode_block_chunk(got[0][1])
            except Exception:
                self.service.peer_manager.report(
                    peer, PeerAction.LOW_TOLERANCE, "undecodable lookup block")
                _lookup_aborted("undecodable")
                return
            if signed.message.hash_tree_root() != block_root:
                # The response is NOT the requested block: penalize the
                # server; the root itself has proven nothing.
                self.service.peer_manager.report(
                    peer, PeerAction.LOW_TOLERANCE,
                    "lookup block root mismatch")
                _lookup_aborted("root_mismatch")
                return
            try:
                self._import_with_blobs(peer, signed)
                log.debug("single-block lookup imported",
                          root=block_root.hex()[:16], peer=peer)
            except BlockError as e:
                msg = str(e)
                if "unknown parent" in msg:
                    try:
                        self.on_unknown_parent(signed, peer)
                    except Exception:
                        pass
                    if chain.fork_choice.contains_block(block_root):
                        return
                if any(t in msg for t in self._TRANSIENT_BLOCK_ERRORS):
                    return  # may import later: learn nothing yet
                # Root-verified block, permanent rejection: remember
                # (reference pre_finalization_block_rejected).
                chain.pre_finalization_cache.block_rejected(block_root)
                log.debug("single-block lookup rejected",
                          root=block_root.hex()[:16], reason=msg[:80])
        finally:
            with self._lock:
                self._lookups_in_flight.discard(block_root)

    def lookup_block_async(self, block_root: bytes, peer: str) -> None:
        """Bounded, de-duplicated spawn: one thread per distinct root, at
        most MAX_CONCURRENT_LOOKUPS in flight (gossip flooding random roots
        must not exhaust threads — the DoS the pre-finalization cache
        exists to blunt)."""
        block_root = bytes(block_root)
        with self._lock:
            if block_root in self._lookups_in_flight:
                return
            if len(self._lookups_in_flight) >= self.MAX_CONCURRENT_LOOKUPS:
                return
            self._lookups_in_flight.add(block_root)
        threading.Thread(
            target=self.lookup_block, args=(block_root, peer),
            daemon=True, name="single-block-lookup",
        ).start()

    # ------------------------------------------------------ parent lookup

    def on_unknown_parent(self, orphan_block, peer: str,
                          depth_limit: int = PARENT_DEPTH_LIMIT) -> None:
        """Fetch the missing ancestry by root and import in order
        (reference ``block_lookups/`` parent lookups).  The chase is bounded
        by ``depth_limit``: a peer feeding an endless orphan chain (or a
        reorg deeper than the cap) aborts with a penalty and a
        ``sync_lookup_aborted_total{reason="depth_limit"}`` tick instead of
        chasing forever."""
        chain = self.chain
        ancestry: List[object] = [orphan_block]
        parent_root = bytes(orphan_block.message.parent_root)
        for _ in range(depth_limit):
            if chain.fork_choice.contains_block(parent_root):
                break
            try:
                chunks = self.service.request(
                    peer,
                    rpc_mod.BLOCKS_BY_ROOT,
                    rpc_mod.BlocksByRootRequest(roots=[parent_root]),
                    timeout=5.0,
                )
            except rpc_mod.RpcError:
                _lookup_aborted("rpc_error")
                return
            got = [c for c in chunks if c[0] == rpc_mod.SUCCESS]
            if not got:
                self.service.peer_manager.report(
                    peer, PeerAction.MID_TOLERANCE, "parent lookup failed"
                )
                _lookup_aborted("not_found")
                return
            try:
                parent = self._decode_block_chunk(got[0][1])
            except Exception:
                self.service.peer_manager.report(
                    peer, PeerAction.LOW_TOLERANCE, "undecodable parent block")
                _lookup_aborted("undecodable")
                return
            ancestry.append(parent)
            parent_root = bytes(parent.message.parent_root)
        else:
            self.service.peer_manager.report(peer, PeerAction.LOW_TOLERANCE, "parent chain too deep")
            _lookup_aborted("depth_limit")
            log.warning("parent chase aborted at depth limit",
                        peer=peer, depth=depth_limit,
                        orphan=bytes(orphan_block.message.hash_tree_root()).hex()[:16])
            return
        for block in reversed(ancestry):
            try:
                chain.process_block(block)
                self.router._publish_light_client_updates()
            except BlockError:
                return
