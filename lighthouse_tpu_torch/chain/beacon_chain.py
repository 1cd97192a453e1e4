"""The chain core: block import pipeline, attestation processing, block and
attestation production, canonical-head management.

Equivalent of the reference's ``beacon_node/beacon_chain`` crate
(`beacon_chain.rs:378-504` ``BeaconChain``; import pipeline
`block_verification.rs:21-45`; production `beacon_chain.rs:4137,4720`;
head recompute `canonical_head.rs:496`), scaled to the harness/test surface
first: everything here runs against ``MemoryStore`` + ``ManualSlotClock`` +
``MockExecutionEngine`` with no networking, the reference's own test topology
(SURVEY.md §4 tier 3).

Block import is the same staged pipeline, with bulk signature verification
(all of a block's signatures in one batched multi-pairing — with the port's
default ``"torch"`` backend one supervised batch on the card) happening inside
``state_transition(strategy=VERIFY_BULK)``.

A copy of the JAX package's ``lighthouse_tpu/chain/beacon_chain.py``.
"""

from __future__ import annotations

import time

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .. import metrics, tracing

from ..logs import get_logger

log = get_logger("chain")
from ..consensus import helpers as h
from ..consensus.per_block import BlockProcessingError, BlockSignatureStrategy
from ..consensus.per_slot import process_slots
from ..consensus.state_transition import state_transition
from ..fork_choice import ExecutionStatus, ForkChoice, InvalidAttestation
from ..op_pool import attester_slashing_indices
from ..store import HotColdDB, MemoryStore
from ..types.spec import ChainSpec
from .events import EventBus
from .mock_el import MockExecutionEngine
from .slot_clock import ManualSlotClock, SlotClock


class ChainError(Exception):
    pass


class BlockError(ChainError):
    pass


class AttestationError(ChainError):
    pass


def genesis_block_root_of(state) -> bytes:
    """Canonical genesis block root: the state's latest header with its
    state_root filled in (how the reference derives it at anchor time)."""
    header = state.latest_block_header.copy()
    header.state_root = state.hash_tree_root()
    return header.hash_tree_root()


class NaiveAggregationPool:
    """Aggregate same-data attestations by OR-ing bits and summing signatures
    (reference: ``beacon_chain/src/naive_aggregation_pool.rs``)."""

    SLOT_RETENTION = 64

    def __init__(self) -> None:
        # (slot, data_root) -> {bits_tuple} aggregated attestation
        self._pool: Dict[Tuple[int, bytes], object] = {}

    def insert(self, attestation) -> None:
        from ..crypto.bls import api as bls

        key = (int(attestation.data.slot), h.attestation_dedup_key(attestation))
        existing = self._pool.get(key)
        if existing is None:
            self._pool[key] = attestation.copy()
            return
        new_bits = list(attestation.aggregation_bits)
        old_bits = list(existing.aggregation_bits)
        if any(a and b for a, b in zip(new_bits, old_bits)):
            return  # overlapping — naive pool only merges disjoint signers
        agg = bls.AggregateSignature.from_bytes(bytes(existing.signature))
        agg.add_assign(bls.Signature.from_bytes(bytes(attestation.signature)))
        existing.aggregation_bits = [a or b for a, b in zip(new_bits, old_bits)]
        existing.signature = agg.to_bytes()

    def get_for_block(self, state, spec: ChainSpec, limit: int) -> List[object]:
        """Attestations eligible for inclusion in a block on ``state``."""
        out = []
        state_slot = int(state.slot)
        for (slot, _), att in sorted(self._pool.items(), key=lambda kv: -kv[0][0]):
            if not spec.attestation_includable(slot, state_slot):
                continue
            out.append(att)
            if len(out) >= limit:
                break
        return out

    def get_aggregate(self, slot: int, data_root: bytes,
                      committee_index: Optional[int] = None):
        """Best aggregate for (slot, attestation_data_root) — the
        ``aggregate_attestation`` API's source (naive_aggregation_pool.rs get).

        Electra entries are keyed with committee_bits appended to the data
        root (attestation_dedup_key), so a plain (slot, data_root) lookup
        must scan key prefixes — otherwise the API 404s for every
        post-electra aggregate (round-2 advisor finding).  ``committee_index``
        (the v2 API's parameter) narrows to one committee; without it the
        fullest matching aggregate wins."""
        slot = int(slot)
        data_root = bytes(data_root)
        att = self._pool.get((slot, data_root))
        if att is not None:
            return att.copy()
        best = None
        best_bits = -1
        for (s, key), cand in self._pool.items():
            if s != slot or not key.startswith(data_root):
                continue
            cb = getattr(cand, "committee_bits", None)
            if committee_index is not None:
                if cb is None or not (
                    committee_index < len(cb) and cb[committee_index]
                ):
                    continue
            nbits = sum(1 for b in cand.aggregation_bits if b)
            if nbits > best_bits:
                best, best_bits = cand, nbits
        return None if best is None else best.copy()

    def prune(self, current_slot: int) -> None:
        cutoff = current_slot - self.SLOT_RETENTION
        self._pool = {k: v for k, v in self._pool.items() if k[0] >= cutoff}


class NaiveSyncContributionPool:
    """Aggregate sync-committee messages into per-subcommittee contributions
    and contributions into block sync aggregates (reference
    ``naive_aggregation_pool.rs``'s SyncContribution flavor +
    ``op_pool``'s sync-contribution handling)."""

    SLOT_RETENTION = 8

    def __init__(self, types, spec: ChainSpec):
        self.types = types
        self.spec = spec
        # (slot, block_root, subcommittee) -> SyncCommitteeContribution
        self._pool: Dict[Tuple[int, bytes, int], object] = {}

    def _sub_size(self) -> int:
        return self.spec.preset.sync_committee_size // self.spec.sync_committee_subnet_count

    def insert_signature(self, slot: int, block_root: bytes, subcommittee: int,
                         position_in_subcommittee: int, signature: bytes) -> None:
        """Merge one already-verified committee member signature."""
        from ..consensus.signature_sets import _sig as cached_sig
        from ..crypto.bls import api as bls

        key = (int(slot), bytes(block_root), int(subcommittee))
        existing = self._pool.get(key)
        if existing is None:
            bits = [False] * self._sub_size()
            bits[position_in_subcommittee] = True
            self._pool[key] = self.types.SyncCommitteeContribution(
                slot=slot,
                beacon_block_root=bytes(block_root),
                subcommittee_index=subcommittee,
                aggregation_bits=bits,
                signature=bytes(signature),
            )
            return
        if existing.aggregation_bits[position_in_subcommittee]:
            return  # already aggregated
        # cached parses: G2 decompression dominates pool merges otherwise
        agg = bls.AggregateSignature.from_signature(cached_sig(bytes(existing.signature)))
        agg.add_assign(cached_sig(bytes(signature)))
        existing.aggregation_bits[position_in_subcommittee] = True
        existing.signature = agg.to_bytes()

    def insert_contribution(self, contribution) -> None:
        """Merge an already-verified (multi-bit) contribution if it has more
        participants than what we hold (best-wins, like the reference pool)."""
        key = (
            int(contribution.slot),
            bytes(contribution.beacon_block_root),
            int(contribution.subcommittee_index),
        )
        existing = self._pool.get(key)
        if existing is None or (
            sum(contribution.aggregation_bits) > sum(existing.aggregation_bits)
        ):
            self._pool[key] = contribution.copy()

    def get_contribution(self, slot: int, block_root: bytes, subcommittee: int):
        c = self._pool.get((int(slot), bytes(block_root), int(subcommittee)))
        return None if c is None else c.copy()

    def best_sync_aggregate(self, slot: int, block_root: bytes):
        """Combine per-subcommittee contributions into a block's
        ``SyncAggregate`` over ``block_root`` signed at ``slot``."""
        from ..consensus.signature_sets import _sig as cached_sig
        from ..crypto.bls import api as bls

        size = self.spec.preset.sync_committee_size
        bits = [False] * size
        agg = bls.AggregateSignature.infinity()
        sub_size = self._sub_size()
        found = False
        for sub in range(self.spec.sync_committee_subnet_count):
            c = self._pool.get((int(slot), bytes(block_root), sub))
            if c is None:
                continue
            found = True
            for i, b in enumerate(c.aggregation_bits):
                if b:
                    bits[sub * sub_size + i] = True
            agg.add_assign(cached_sig(bytes(c.signature)))
        return self.types.SyncAggregate(
            sync_committee_bits=bits,
            sync_committee_signature=agg.to_bytes() if found else b"\xc0" + b"\x00" * 95,
        )

    def prune(self, current_slot: int) -> None:
        cutoff = current_slot - self.SLOT_RETENTION
        self._pool = {k: v for k, v in self._pool.items() if k[0] >= cutoff}


class AttestationCandidate:
    """A spec-checked, indexed attestation awaiting signature verification
    (the unit the gossip batch verifier coalesces).  ``state`` is the state
    the attestation was indexed against (needed to build the aggregate's
    extra signature sets without re-deriving committees)."""

    __slots__ = ("attestation", "indexed", "signature_set", "state")

    def __init__(self, attestation, indexed, signature_set, state=None):
        self.attestation = attestation
        self.indexed = indexed
        self.signature_set = signature_set
        self.state = state


class AggregateCandidate:
    """A spec-checked SignedAggregateAndProof awaiting signature verification.

    Carries the reference's THREE signature sets per aggregate
    (``attestation_verification/batch.rs:31-135``): selection proof, outer
    AggregateAndProof signature, inner indexed-attestation set."""

    __slots__ = ("signed_aggregate", "inner", "signature_sets")

    def __init__(self, signed_aggregate, inner: AttestationCandidate, signature_sets):
        self.signed_aggregate = signed_aggregate
        self.inner = inner
        self.signature_sets = signature_sets


#: The furthest the head may lag the clock for the state-advance timer to
#: pre-advance it (the reference's ``state_advance_timer.rs``).
MAX_ADVANCE_DISTANCE = 4


class BeaconChain:
    def __init__(
        self,
        *,
        genesis_state,
        types,
        spec: ChainSpec,
        store: Optional[MemoryStore] = None,
        db: Optional[HotColdDB] = None,
        slot_clock: Optional[SlotClock] = None,
        execution_engine: Optional[MockExecutionEngine] = None,
        kzg=None,
        anchor_block=None,
    ):
        """``anchor_block``: checkpoint sync (weak subjectivity) — boot from a
        finalized (state, block) pair instead of genesis: ``genesis_state``
        is then the anchor block's post-state, the anchor root plays the
        genesis-root role in fork choice, and backfill later fills history
        behind it (reference ``client/src/builder.rs:341-528``)."""
        self.spec = spec
        self.types = types
        if db is not None:
            if store is not None:
                raise ChainError("pass either store= or db=, not both")
            db.types = types if db.types is None else db.types
            db.spec = spec if db.spec is None else db.spec
            self.db = db
            self.store = db.hot
        else:
            self.store = store if store is not None else MemoryStore()
            self.db = HotColdDB(hot=self.store, types=types, spec=spec)
        self.execution_engine = (
            execution_engine if execution_engine is not None else MockExecutionEngine()
        )
        if hasattr(self.execution_engine, "on_payload_attributes"):
            # SSE payload_attributes (reference events.rs topic): emit what
            # rides forkchoiceUpdated so external builders can prepare
            from . import events as ev

            def _emit_payload_attributes(fork, st, attributes):
                try:
                    proposer = h.get_beacon_proposer_index(st, self.spec)
                except Exception:
                    proposer = 0
                exec_header = getattr(
                    st, "latest_execution_payload_header", None)
                self.events.publish(ev.TOPIC_PAYLOAD_ATTRIBUTES, {
                    "version": fork,
                    "data": {
                        # beacon-API SsePayloadAttributes shape
                        "proposer_index": str(int(proposer)),
                        "proposal_slot": str(int(st.slot)),
                        "parent_block_number": str(
                            int(exec_header.block_number) if exec_header else 0),
                        "parent_block_root": "0x" + bytes(
                            st.latest_block_header.hash_tree_root()).hex(),
                        "parent_block_hash": "0x" + (
                            bytes(exec_header.block_hash).hex()
                            if exec_header else "00" * 32),
                        "payload_attributes": attributes,
                    },
                })

            self.execution_engine.on_payload_attributes = _emit_payload_attributes
        self.kzg = kzg
        self.genesis_state = genesis_state
        self.genesis_time = int(genesis_state.genesis_time)
        self.genesis_validators_root = bytes(genesis_state.genesis_validators_root)
        self.slot_clock = (
            slot_clock
            if slot_clock is not None
            else ManualSlotClock(self.genesis_time, spec.seconds_per_slot)
        )

        self.genesis_block_root = genesis_block_root_of(genesis_state)
        self.anchor_slot = int(genesis_state.slot)  # 0 for a genesis boot
        # Object caches over the store (the reference's snapshot/state caches).
        self._blocks: Dict[bytes, object] = {}
        self._states: Dict[bytes, object] = {}  # post-state by block root
        self._state_class: Dict[bytes, type] = {}
        # Payload-free persistence + on-read reconstruction (reference
        # beacon_block_streamer.rs): with store_payloads=False, post-merge
        # blocks hit the DB blinded and get_block rebuilds the payload from
        # the EL via engine_getPayloadBodiesByHash.  Must exist before the
        # anchor/genesis _store_block below.
        from .block_streamer import BeaconBlockStreamer

        self.store_payloads: bool = True
        self.block_streamer = BeaconBlockStreamer(self)
        if anchor_block is not None:
            anchor_root = anchor_block.message.hash_tree_root()
            if anchor_root != self.genesis_block_root:
                raise ChainError(
                    "anchor_block does not match the anchor state's latest header"
                )
            self._store_block(anchor_root, anchor_block, genesis_state)
        else:
            self._store_block(self.genesis_block_root, None, genesis_state)
        if self.anchor_slot > self.db.get_split_slot():
            # A checkpoint-synced store holds no history below its anchor,
            # so its freezer starts there (the reference's split at the
            # anchor slot, beside the block root at it, as migrate() writes
            # it).  The JAX package's copy leaves the split at 0: its first
            # migration walks from slot 0 and, for a restore point older
            # than the anchor's root vectors, rewinds the anchor and fails.
            self.db.put_split(self.anchor_slot, self.genesis_block_root)

        self.fork_choice = ForkChoice(
            spec=spec,
            genesis_block_root=self.genesis_block_root,
            genesis_state=genesis_state,
        )
        self.fork_choice.set_justified_state_provider(self.get_state)
        from ..op_pool import OperationPool

        self.head_root = self.genesis_block_root
        self.attestation_pool = NaiveAggregationPool()
        self.sync_contribution_pool = NaiveSyncContributionPool(types, spec)
        from .light_client import LightClientServerCache

        self.lc_cache = LightClientServerCache(types, spec)
        self.builder = None  # external MEV relay client (set by the builder)
        self.eth1_service = None  # deposit follower + eth1 voting (optional)
        # state-advance cache: (head_root, slot, advanced_state)
        self._advanced: Optional[Tuple[bytes, int, object]] = None
        self._advance_hits = 0
        # validator index -> fee recipient (reference proposer_prep_service /
        # prepare_beacon_proposer; consumed by payload production)
        self.proposer_preparations: Dict[int, bytes] = {}
        from .validator_monitor import ValidatorMonitor

        self.validator_monitor = ValidatorMonitor(spec)
        self.builder_pubkey = None  # operator-pinned relay identity (optional)
        from .attester_cache import EarlyAttesterCache

        self.early_attester_cache = EarlyAttesterCache()
        # Late-block proposer re-org config (reference chain_config.rs:6-10
        # defaults; set re_org_head_threshold to None to disable).
        self.re_org_head_threshold: Optional[int] = 20
        self.re_org_parent_threshold: int = 160
        self.re_org_max_epochs_since_finalization: int = 2
        self.re_org_cutoff_denominator: int = 12
        self.re_org_disallowed_offsets: tuple = ()
        # Import-time block arrival delays (root -> seconds into its slot),
        # consulted by the proposer re-org head_late gate
        # (beacon_chain.rs:4289-4290).  Bounded: pruned FIFO past 128 roots.
        self._block_delays: "OrderedDict[bytes, float]" = OrderedDict()
        self.op_pool = OperationPool()
        self.observed_block_roots: set = set()
        self._migrated_slot = 0
        self.events = EventBus()
        # Device circuit-breaker transitions (device_supervisor.py) publish
        # to this bus as `device_breaker` SSE events (weakly registered —
        # harness-built chains drop out on GC).
        from .. import device_supervisor

        device_supervisor.register_event_bus(self.events)
        # Synchronous import-completion hooks (root) — the router's
        # reprocess queue releases parked unknown-head attestations here
        # the moment the block they vote for lands (any import path:
        # gossip, range sync, parent chase).
        self.block_imported_hooks: list = []
        self._last_finalized_epoch = 0
        from .observed import ObservedCaches

        self.observed = ObservedCaches()
        from .da import DataAvailabilityChecker

        self.da_checker = DataAvailabilityChecker(
            spec=spec, types=types, kzg=kzg,
            header_verifier=self.verify_block_header_signature,
            slot_provider=self.current_slot,
        )
        self._blob_sidecars: Dict[bytes, list] = {}
        from .pre_finalization_cache import PreFinalizationBlockCache

        self.pre_finalization_cache = PreFinalizationBlockCache()
        from .graffiti_calculator import GraffitiCalculator

        self.graffiti_calculator = GraffitiCalculator(
            execution_engine=self.execution_engine
        )
        from .otb_verification import OtbStore

        self.otb_store = OtbStore(self.db)

    # ------------------------------------------------------------- storage

    def _store_block(self, block_root: bytes, signed_block, post_state) -> None:
        if signed_block is not None:
            self._blocks[block_root] = signed_block
            if not self.store_payloads and hasattr(
                signed_block.message.body, "execution_payload"
            ):
                from .block_streamer import blind_signed_block

                self.db.put_blinded_block(
                    block_root, blind_signed_block(signed_block, self.types)
                )
            else:
                self.db.put_block(block_root, signed_block)
            # The post-state root was verified against the block's claim in
            # state_transition — reuse it instead of re-merkleizing.
            state_root = bytes(signed_block.message.state_root)
        else:
            state_root = post_state.hash_tree_root()  # genesis
        self._states[block_root] = post_state
        self.db.put_state(state_root, post_state, block_root)

    def get_block(self, block_root: bytes):
        """FULL block by root — object cache first, store fallback (the
        reference can always reach the store when its block cache misses),
        then the early-attester cache for a block that is verified but not
        yet written (peers may request it over RPC the moment it hits
        gossip).  A blinded store hit is reconstructed through the block
        streamer (payload from the EL), so every serving path — HTTP blocks,
        BlocksByRange/Root — hands out full blocks transparently."""
        block = self._blocks.get(block_root)
        if block is None:
            block = self.db.get_block(block_root)
            if block is not None:
                from .block_streamer import is_blinded

                if is_blinded(block):
                    block = self.block_streamer.reconstruct_one(block)
        if block is None:
            block = self.early_attester_cache.get_block(block_root)
        return block

    def _raw_block(self, block_root: bytes):
        """The stored form without payload reconstruction (may be blinded):
        memory cache -> db -> early-attester cache.  The EL-free invariant
        every slot/metadata lookup depends on lives HERE only."""
        block = self._blocks.get(block_root) or self.db.get_block(block_root)
        if block is None:
            block = self.early_attester_cache.get_block(block_root)
        return block

    def get_blocks(self, block_roots) -> list:
        """FULL blocks for many roots with ONE batched EL round trip for
        every blinded store hit (the reference's beacon_block_streamer range
        path) — N-block BlocksByRange must not cost N
        engine_getPayloadBodiesByHash calls."""
        return self.block_streamer.reconstruct(
            [self._raw_block(root) for root in block_roots]
        )

    def get_blinded_block(self, block_root: bytes):
        """The block in blinded form (payload header), reading the blinded
        store representation directly when present."""
        from .block_streamer import blind_signed_block, is_blinded

        block = self._raw_block(block_root)
        if block is None or is_blinded(block):
            return block
        if not hasattr(block.message.body, "execution_payload"):
            return block  # pre-merge: blinded == full
        return blind_signed_block(block, self.types)

    def get_blobs(self, block_root: bytes) -> list:
        """Blob sidecars stored at import or backfill (memory first, store
        fallback — the blob_sidecars API's and blob RPC's source)."""
        mem = self._blob_sidecars.get(block_root)
        if mem is not None:
            return list(mem)
        return self.db.get_blobs(block_root)

    def store_backfilled_blobs(self, signed_block, sidecars) -> None:
        """Persist sidecars for a hash-chain-verified BACKFILLED block.

        Full verification, not just commitment equality: exact index
        coverage, commitment match against the verified block, and the KZG
        batch proof (a copied commitment over garbage blob bytes must not
        be served).  Raises ``BlockError`` on any failure."""
        commitments = list(
            getattr(signed_block.message.body, "blob_kzg_commitments", []) or []
        )
        block_root = signed_block.message.hash_tree_root()
        got = sorted(sidecars, key=lambda s: int(s.index))
        if [int(s.index) for s in got] != list(range(len(commitments))):
            raise BlockError("backfilled sidecars do not cover indices exactly")
        for sc in got:
            if bytes(sc.kzg_commitment) != bytes(commitments[int(sc.index)]):
                raise BlockError("backfilled sidecar commitment mismatch")
        if self.kzg is None:
            raise BlockError("no KZG engine: cannot verify backfilled blobs")
        if not self.kzg.verify_blob_kzg_proof_batch(
            [bytes(sc.blob) for sc in got],
            [bytes(sc.kzg_commitment) for sc in got],
            [bytes(sc.kzg_proof) for sc in got],
        ):
            raise BlockError("backfilled blob KZG verification failed")
        self.db.put_blobs(block_root, got)

    def get_state(self, block_root: bytes):
        """Post-state for ``block_root`` — object cache first, then the hot
        store by the block's claimed state root, then cold-store replay
        (reference snapshot-cache-miss path, ``beacon_chain.rs:378-504``:
        a cache miss is a slow path, never an error)."""
        state = self._states.get(block_root)
        if state is not None:
            return state
        if block_root == self.genesis_block_root:
            state = self.genesis_state
        else:
            block = self.get_block(block_root)
            if block is None:
                return None
            state = self.db.get_hot_state(bytes(block.message.state_root))
            if state is None:
                # Finalized history: rebuild from the nearest restore point.
                # Only canonical-finalized roots exist cold-side, so verify
                # the block root at that slot matches before trusting it.
                slot = int(block.message.slot)
                if self.db.cold_block_root_at_slot(slot) == block_root:
                    state = self.db.load_cold_state_by_slot(slot)
        if state is not None:
            self._states[block_root] = state
        return state

    @property
    def head_state(self):
        state = self.get_state(self.head_root)
        if state is None:
            raise ChainError(
                f"head state for {self.head_root.hex()[:16]} missing from cache and store"
            )
        return state

    def head_slot(self) -> int:
        """Slot of the current head block (the notifier/monitoring figure)."""
        return self._blocks_slot(self.head_root)

    def current_slot(self) -> int:
        now = self.slot_clock.now()
        return now if now is not None else 0

    # ------------------------------------------------------- block import

    def process_block(self, signed_block, block_delay_seconds: Optional[float] = None) -> bytes:
        """Full import pipeline (reference ``beacon_chain.rs:3035``
        ``process_block`` + ``:3362 import_block``): state catch-up, bulk
        signature verification, state-root check, payload notify, fork choice,
        persistence, head recompute."""
        with tracing.span(
            "block_import", hist=metrics.BLOCK_IMPORT_SECONDS,
            slot=int(signed_block.message.slot),
        ):
            return self._process_block_inner(signed_block, block_delay_seconds)

    def process_block_with_blobs(self, signed_block, sidecars,
                                 block_delay_seconds: Optional[float] = None) -> bytes:
        """Import a block together with its blob sidecars (RPC/API path)."""
        with tracing.span(
            "block_import", hist=metrics.BLOCK_IMPORT_SECONDS,
            slot=int(signed_block.message.slot),
        ):
            return self._process_block_inner(
                signed_block, block_delay_seconds, sidecars=sidecars
            )

    def _process_block_inner(self, signed_block, block_delay_seconds, sidecars=None):
        t_import = time.perf_counter()
        block = signed_block.message
        block_root = block.hash_tree_root()
        tracing.annotate(root="0x" + block_root.hex()[:16])
        # Key the whole trace by this import's slot, whatever span is the
        # root (work:gossip_block, http_request, or block_import itself).
        tracing.annotate_trace(slot=int(block.slot))
        if block_root in self._blocks or block_root == self.genesis_block_root:
            return block_root  # duplicate import is a no-op
        current_slot = self.current_slot()
        if int(block.slot) > current_slot:
            raise BlockError(f"block from future slot {block.slot} (now {current_slot})")
        parent_root = bytes(block.parent_root)
        parent_state = self.get_state(parent_root)
        if parent_state is None:
            raise BlockError(f"unknown parent {parent_root.hex()[:16]}")

        # Deneb data-availability gate (data_availability_checker.rs): a
        # block with commitments imports only when every blob is verified.
        # Runs AFTER the slot/parent sanity checks so junk blocks can never
        # park in the pending store (DoS surface).
        if getattr(block.body, "blob_kzg_commitments", None):
            from .da import BlobError

            try:
                with tracing.span("da_check", hist=metrics.BLOCK_DA_CHECK_SECONDS):
                    status, result = self.da_checker.check_availability(
                        signed_block, sidecars=sidecars
                    )
            except BlobError as e:
                raise BlockError(f"blob verification failed: {e}") from e
            if status != "available":
                # Only proposer-authenticated blocks may park in the capped
                # pending store — unsigned junk must not be able to evict an
                # honest block waiting for its blobs.
                header = self.types.SignedBeaconBlockHeader(
                    message=self.types.BeaconBlockHeader(
                        slot=block.slot,
                        proposer_index=block.proposer_index,
                        parent_root=block.parent_root,
                        state_root=block.state_root,
                        body_root=block.body.hash_tree_root(),
                    ),
                    signature=signed_block.signature,
                )
                if self.verify_block_header_signature(header):
                    self.da_checker.put_pending_block(signed_block)
                raise BlockError(f"pending availability: missing blobs {result}")
            blob_sidecars = result
        else:
            blob_sidecars = []

        state = parent_state.copy()
        try:
            with tracing.span(
                "state_transition", hist=metrics.BLOCK_STATE_TRANSITION_SECONDS
            ):
                state = state_transition(
                    state,
                    signed_block,
                    self.types,
                    self.spec,
                    strategy=BlockSignatureStrategy.VERIFY_BULK,
                    validate_result=True,
                    payload_verifier=self._payload_verifier_for(signed_block),
                )
        except (BlockProcessingError, ValueError) as e:
            raise BlockError(f"state transition failed: {e}") from e

        if block_delay_seconds is None:
            # Delay relative to the BLOCK'S OWN slot start (reference
            # block_times_cache semantics) — a slot-N block arriving during
            # slot N+1 is very late, not "0.5 s into the current slot".
            now = self.slot_clock._seconds()
            start = self.slot_clock.start_of(int(block.slot))
            block_delay_seconds = max(0.0, now - start)
        self._block_delays[block_root] = float(block_delay_seconds)
        while len(self._block_delays) > 128:
            self._block_delays.popitem(last=False)
        metrics.BLOCK_ARRIVAL_DELAY_SECONDS.observe(float(block_delay_seconds))
        tracing.annotate(arrival_delay_s=round(float(block_delay_seconds), 3))
        if hasattr(block.body, "execution_payload"):
            ph = bytes(block.body.execution_payload.block_hash)
            optimistic = getattr(self.execution_engine, "optimistic_hashes", None)
            payload_status = (
                ExecutionStatus.OPTIMISTIC
                if optimistic is not None and ph in optimistic
                else ExecutionStatus.VALID
            )
            if payload_status == ExecutionStatus.OPTIMISTIC:
                from ..consensus.per_block import is_merge_transition_complete

                if not is_merge_transition_complete(parent_state) and any(ph):
                    # The MERGE TRANSITION block went in unverified: its PoW
                    # parent must be TTD-checked once the EL can answer
                    # (otb_verification_service.rs).
                    self.otb_store.register(block_root, int(block.slot))
        else:
            payload_status = ExecutionStatus.IRRELEVANT
        with tracing.span("fork_choice", hist=metrics.BLOCK_FORK_CHOICE_SECONDS):
            self.fork_choice.on_block(
                current_slot=current_slot,
                block=block,
                block_root=block_root,
                state=state,
                payload_verification_status=payload_status,
                block_delay_seconds=block_delay_seconds,
            )
        # The block is fully verified: attestations to it can be produced
        # NOW, before the store write / head recompute below (reference
        # early_attester_cache.rs — the 4 s attestation deadline must not
        # wait on the database).
        self.early_attester_cache.add_head_block(
            block_root, signed_block, state, self.types, self.spec,
            blobs=blob_sidecars,
        )
        with tracing.span("store_write", hist=metrics.BLOCK_STORE_WRITE_SECONDS):
            from .. import fault_injection

            fault_injection.check("store.write")
            self._store_block(block_root, signed_block, state)
        self.observed_block_roots.add(block_root)
        self.pre_finalization_cache.block_processed(block_root)
        self._update_light_client_cache(signed_block, parent_root, parent_state)
        if blob_sidecars:
            self._blob_sidecars[block_root] = list(blob_sidecars)
            for sc in blob_sidecars:
                self.events.publish("blob_sidecar", {
                    "block_root": "0x" + block_root.hex(),
                    "index": str(int(sc.index)),
                    "slot": str(int(block.slot)),
                    "kzg_commitment": "0x" + bytes(sc.kzg_commitment).hex(),
                })

        # Feed the block's attestations to fork choice (reference
        # ``import_block`` → on_attestation(is_from_block=true)).
        for att in block.body.attestations:
            try:
                indexed = h.get_indexed_attestation(state, att, self.types, self.spec)
                # Head/target correctness vs the including chain (reference
                # validator_monitor.rs attestation scoring); None when the
                # root is not yet derivable from this state's history.
                head_hit = target_hit = None
                try:
                    head_hit = bytes(att.data.beacon_block_root) == bytes(
                        h.get_block_root_at_slot(state, int(att.data.slot), self.spec)
                    )
                except Exception:
                    pass
                try:
                    target_hit = bytes(att.data.target.root) == bytes(
                        h.get_block_root(state, int(att.data.target.epoch), self.spec)
                    )
                except Exception:
                    pass
                self.validator_monitor.on_attestation_included(
                    int(att.data.target.epoch), indexed.attesting_indices,
                    head_hit=head_hit, target_hit=target_hit,
                    inclusion_distance=int(block.slot) - int(att.data.slot),
                )
                for idx in indexed.attesting_indices:
                    self.observed.block_attesters.observe(
                        int(att.data.target.epoch), int(idx)
                    )
                self.fork_choice.on_attestation(
                    current_slot=current_slot,
                    attestation_slot=int(att.data.slot),
                    attesting_indices=list(indexed.attesting_indices),
                    beacon_block_root=bytes(att.data.beacon_block_root),
                    target_epoch=int(att.data.target.epoch),
                    target_root=bytes(att.data.target.root),
                    is_from_block=True,
                )
            except InvalidAttestation:
                continue  # attestations for unknown forks don't block import
        # Block-included slashings convict equivocators: mask their
        # fork-choice weight even when the slashing never crossed our gossip
        # path (reference import_block -> on_attester_slashing per included
        # slashing).  state.validators[i].slashed already flipped in the
        # state transition above.
        for slashing in getattr(block.body, "attester_slashings", ()):
            self.fork_choice.on_attester_slashing(
                attester_slashing_indices(slashing))
        self.validator_monitor.on_block_imported(
            int(block.slot), int(block.proposer_index)
        )
        if (self.validator_monitor.monitored
                and hasattr(block.body, "sync_aggregate")):
            try:
                committee = self._sync_committee_member_indices(state)
                bits = block.body.sync_aggregate.sync_committee_bits
                participating = {v for i, v in enumerate(committee) if bits[i]}
                # per-VALIDATOR judgment: a member repeating across
                # positions participates if ANY of its bits is set — a
                # partially-aggregated contribution is not a miss
                missing = set(committee) - participating
                self.validator_monitor.on_sync_aggregate(
                    int(block.slot), participating, missing)
            except Exception:
                pass  # monitoring must never block an import

        self.recompute_head()
        if self.head_root == block_root:
            # Score strictly against the CANONICAL chain: only the block
            # that fork choice just made head may consume simulated votes
            # (a side-fork post-state would grade them against the wrong
            # branch and destroy them).
            self.validator_monitor.score_simulated_attestations(
                state, self.spec, h
            )
        if int(block.slot) == current_slot:
            # Re-vote the simulator for this slot now its block is here:
            # the reference fires at +1/3 INTO the slot (after a timely
            # block); the slot-start vote stands only for empty slots.
            self.simulate_attestation()
        self.events.block(slot=int(block.slot), block_root=block_root)
        # Import-completion delay against the block's OWN slot start (the
        # reference's beacon_block_delay_imported figure — arrival delay
        # plus everything the pipeline added on top).
        metrics.BLOCK_IMPORTED_DELAY_SECONDS.observe(max(
            0.0,
            self.slot_clock._seconds() - self.slot_clock.start_of(int(block.slot)),
        ))
        # Reference beacon_chain.rs logs every import with slot/root/delay
        # (the notifier and Siren both read these).
        log.info(
            "block imported",
            slot=int(block.slot),
            root="0x" + block_root.hex()[:16],
            delay_s=round(float(block_delay_seconds), 3),
            import_s=round(time.perf_counter() - t_import, 3),
            attestations=len(block.body.attestations),
        )
        for hook in list(self.block_imported_hooks):
            try:
                hook(block_root)
            except Exception:
                pass  # a subscriber must never fail an import
        return block_root

    def verify_block_header_signature(self, signed_header) -> bool:
        """Proposer signature on a detached ``SignedBeaconBlockHeader`` (the
        blob-sidecar gossip rule — a forged header must not enter the DA
        cache or be re-forwarded)."""
        from ..consensus import signature_sets as sets
        from ..crypto.bls import api as bls
        from ..types.spec import DOMAIN_BEACON_PROPOSER

        header = signed_header.message
        state = self.get_state(bytes(header.parent_root)) or self.head_state
        proposer = int(header.proposer_index)
        if proposer >= len(state.validators):
            return False
        epoch = int(header.slot) // self.spec.slots_per_epoch
        # Domain from the fork AT THE HEADER'S EPOCH (not the parent state's
        # fork object) — the parent of the first post-fork block is still
        # pre-fork, but the proposer signed with the new version.
        fork_version = self.spec.fork_version_for(self.spec.fork_name_at_epoch(epoch))
        domain = h.compute_domain(
            DOMAIN_BEACON_PROPOSER, fork_version, self.genesis_validators_root
        )
        root = h.compute_signing_root(header.hash_tree_root(), domain)
        try:
            pk = sets.pubkey_cache(bytes(state.validators[proposer].pubkey))
            s = bls.SignatureSet.single_pubkey(
                bls.Signature.from_bytes(bytes(signed_header.signature)), pk, root
            )
            # through the active backend (fake/host/torch), like every other
            # chain signature check
            return bls.verify_signature_sets([s])
        except (bls.BlsError, ValueError):
            return False

    def _payload_verifier_for(self, signed_block):
        """The payload_verifier closure for one block's import.  A real
        ``ExecutionLayer`` needs the deneb extras (blob versioned hashes +
        parent beacon block root, engine_newPayloadV3); the in-proc mock's
        plain ``notify_new_payload(payload)`` is used as-is."""
        el = self.execution_engine
        if not hasattr(el, "notify_forkchoice_updated"):
            return el.notify_new_payload  # in-proc mock
        body = signed_block.message.body
        commitments = list(getattr(body, "blob_kzg_commitments", []) or [])
        if not commitments and type(signed_block.message).fork_name not in (
            "deneb", "electra",
        ):
            return el.notify_new_payload
        from ..execution_layer.engine_api import kzg_commitment_to_versioned_hash

        versioned = [kzg_commitment_to_versioned_hash(c) for c in commitments]
        parent_root = bytes(signed_block.message.parent_root)
        fork = type(signed_block.message).fork_name
        requests = getattr(body, "execution_requests", None)
        return lambda payload: el.notify_new_payload(
            payload,
            versioned_hashes=versioned,
            parent_beacon_block_root=parent_root,
            execution_requests=requests,
            fork=fork,
        )

    # ------------------------------------------------- attestation import

    def preverify_attestation(self, attestation) -> "AttestationCandidate":
        """Spec checks + committee indexing; returns a candidate carrying the
        signature set WITHOUT verifying it — the gossip batch coalescer
        verifies many candidates in one device program
        (reference ``attestation_verification.rs`` split into
        ``verify_*_for_gossip`` parts 1/2 around the batch seam)."""
        from ..consensus import signature_sets as sets
        from ..crypto.bls import api as bls

        data = attestation.data
        head_root = bytes(data.beacon_block_root)
        state = self.get_state(head_root)
        if state is None:
            raise AttestationError("attestation references unknown head block")
        base = state
        if h.compute_epoch_at_slot(int(data.slot), self.spec) > h.get_current_epoch(
            base, self.spec
        ):
            base = base.copy()
            process_slots(
                base,
                h.compute_start_slot_at_epoch(
                    h.compute_epoch_at_slot(int(data.slot), self.spec), self.spec
                ),
                self.types,
                self.spec,
            )
        try:
            indexed = h.get_indexed_attestation(base, attestation, self.types, self.spec)
        except Exception as e:
            raise AttestationError(f"cannot index attestation: {e}") from e
        try:
            sig_set = sets.indexed_attestation_signature_set(base, indexed, self.spec)
        except bls.BlsError as e:
            raise AttestationError(f"malformed attestation signature: {e}") from e
        return AttestationCandidate(attestation, indexed, sig_set, state=base)

    def preverify_aggregate(self, signed_aggregate) -> "AggregateCandidate":
        """Spec checks for a ``SignedAggregateAndProof`` (reference
        ``verify_aggregated_attestation_for_gossip``,
        ``attestation_verification.rs``): the aggregator must be a member of
        the attestation's committee AND pass the spec ``is_aggregator``
        selection gate, and THREE signature sets are built — selection proof,
        outer AggregateAndProof signature, inner indexed attestation — all
        left unverified for the batch coalescer.  Skipping any of these lets
        a peer mint wraps around public aggregates to censor honest
        aggregators (round-2 advisor finding)."""
        import hashlib

        from ..consensus import signature_sets as sets
        from ..crypto.bls import api as bls

        msg = signed_aggregate.message
        attestation = msg.aggregate
        inner = self.preverify_attestation(attestation)
        base = inner.state
        data = attestation.data
        slot = int(data.slot)
        aggregator_index = int(msg.aggregator_index)
        if aggregator_index >= len(base.validators):
            raise AttestationError("aggregator index out of range")
        if hasattr(attestation, "committee_bits"):
            committee_indices = h.get_committee_indices(attestation.committee_bits)
            if len(committee_indices) != 1:
                raise AttestationError("electra aggregate must set exactly one committee bit")
            committee_index = committee_indices[0]
        else:
            committee_index = int(data.index)
        committee = h.get_beacon_committee(base, slot, committee_index, self.spec)
        if aggregator_index not in {int(i) for i in committee}:
            raise AttestationError("aggregator is not in the attestation committee")
        modulo = max(1, len(committee) // self.spec.target_aggregators_per_committee)
        digest = hashlib.sha256(bytes(msg.selection_proof)).digest()
        if int.from_bytes(digest[:8], "little") % modulo != 0:
            raise AttestationError("validator is not a selected aggregator for this slot")
        try:
            selection_set = sets.selection_proof_signature_set(
                base, aggregator_index, slot, msg.selection_proof, self.spec
            )
            outer_set = sets.aggregate_and_proof_signature_set(
                base, signed_aggregate, self.spec
            )
        except bls.BlsError as e:
            raise AttestationError(f"malformed aggregate signature: {e}") from e
        return AggregateCandidate(
            signed_aggregate, inner, [selection_set, outer_set, inner.signature_set]
        )

    # ------------------------------------------------------- light client

    def _update_light_client_cache(self, signed_block, parent_root: bytes,
                                   parent_state) -> None:
        """Produce LC objects from an imported block (reference
        ``light_client_server_cache.rs`` recompute_and_cache_updates)."""
        from .light_client import block_to_lc_header  # noqa: F401 (cycle guard)

        parent_block = self.get_block(parent_root)
        if parent_block is None:
            if parent_root != self.genesis_block_root:
                return
            header = self.genesis_state.latest_block_header.copy()
            header.state_root = self.genesis_state.hash_tree_root()
            parent_block = header
        f_root = bytes(parent_state.finalized_checkpoint.root)
        finalized_block = self.get_block(f_root) if any(f_root) else None
        try:
            self.lc_cache.on_block_imported(
                block=signed_block,
                parent_block=parent_block,
                parent_state=parent_state,
                finalized_block=finalized_block,
            )
        except Exception:
            pass  # LC production must never break block import

    def produce_light_client_bootstrap(self, block_root: bytes):
        """Bootstrap for a (finalized) block root, built on demand."""
        block = self.get_block(block_root)
        state = self.get_state(block_root)
        if block is None or state is None:
            return None
        return self.lc_cache.produce_bootstrap(state, block)

    # ------------------------------------------------ sync committee duty

    def _sync_committee_for_slot(self, state, slot: int):
        """The committee actually signing at ``slot``: at a sync-committee
        period boundary (or when the head state lags the wall clock into the
        next period) the message's period may be the state's NEXT period —
        checking ``current_sync_committee`` unconditionally rejects valid
        messages from the new committee (reference
        ``sync_committee_verification.rs`` resolves the duty-epoch
        committee the same way)."""
        from ..consensus.helpers import compute_sync_committee_period

        # Duty period of slot+1, not slot: sync-committee messages at the
        # LAST slot of a period are signed by the NEXT committee (reference
        # ``sync_committee_at_next_slot``, beacon_chain.rs:1288).
        msg_period = compute_sync_committee_period(
            (int(slot) + 1) // self.spec.slots_per_epoch, self.spec
        )
        state_period = compute_sync_committee_period(
            int(state.slot) // self.spec.slots_per_epoch, self.spec
        )
        if msg_period == state_period + 1:
            return state.next_sync_committee
        return state.current_sync_committee

    def _expected_proposer(self, slot: int) -> Optional[int]:
        """The expected proposer at ``slot``, from an epoch-level cache
        (reference ``beacon_proposer_cache.rs``): the whole epoch's mapping
        is computed once while the head state can derive it, and survives
        the head advancing into the next epoch — so the last slots of an
        epoch stay checkable.  None when the shuffling is underivable
        (e.g. a long outage with the head frozen epochs behind); a deep
        reorg across the epoch boundary can stale one epoch's cache
        (monitoring-grade accuracy, not consensus)."""
        epoch = slot // self.spec.slots_per_epoch
        cache = getattr(self, "_proposer_epoch_cache", None)
        if cache is not None and cache[0] == epoch:
            return cache[1].get(slot)
        head_epoch = int(self.head_state.slot) // self.spec.slots_per_epoch
        if head_epoch != epoch:
            return None
        start = epoch * self.spec.slots_per_epoch
        mapping = {}
        for s in range(start, start + self.spec.slots_per_epoch):
            try:
                mapping[s] = h.get_beacon_proposer_index(
                    self.head_state, self.spec, slot=s)
            except Exception:
                continue
        self._proposer_epoch_cache = (epoch, mapping)
        return mapping.get(slot)

    def _sync_committee_member_indices(self, state) -> List[int]:
        """Validator indices of the CURRENT sync committee, position-aligned
        with its pubkeys (cached per sync period — the pubkey scan is
        O(validators) and the committee is stable for a whole period)."""
        period = (
            h.get_current_epoch(state, self.spec)
            // self.spec.preset.epochs_per_sync_committee_period
        )
        cached = getattr(self, "_sync_indices_cache", None)
        if cached is not None and cached[0] == period:
            return cached[1]
        by_pubkey = {
            bytes(v.pubkey): i for i, v in enumerate(state.validators)
        }
        indices = [
            by_pubkey.get(bytes(pk), -1)
            for pk in state.current_sync_committee.pubkeys
        ]
        self._sync_indices_cache = (period, indices)
        return indices

    def _sync_committee_positions(self, state, validator_index: int,
                                  slot: int) -> List[int]:
        committee = self._sync_committee_for_slot(state, slot)
        pk = bytes(state.validators[validator_index].pubkey)
        return [
            i for i, p in enumerate(committee.pubkeys)
            if bytes(p) == pk
        ]

    def _preverify_sync_message(self, msg, state):
        """Spec checks + signature-set construction for one message; the
        batch entry point verifies many sets in ONE backend call."""
        from ..consensus import signature_sets as sets

        current_slot = self.current_slot()
        if not (current_slot - 1 <= int(msg.slot) <= current_slot + 1):
            # spec gossip rule: the message slot must be current (±1 here for
            # clock skew); without this, validly-signed far-future messages
            # would pool forever (prune keeps future keys)
            raise AttestationError(
                f"sync message slot {msg.slot} outside the current-slot window"
            )
        vidx = int(msg.validator_index)
        if vidx >= len(state.validators):
            raise AttestationError("sync message validator index out of range")
        positions = self._sync_committee_positions(state, vidx, slot=int(msg.slot))
        if not positions:
            raise AttestationError("validator is not in the current sync committee")
        sig_set = sets.sync_committee_message_set(
            state, vidx, bytes(msg.beacon_block_root), int(msg.slot),
            msg.signature, self.spec,
        )
        return positions, sig_set

    def _pool_sync_message(self, msg, positions) -> None:
        sub_size = self.sync_contribution_pool._sub_size()
        for pos in positions:
            self.sync_contribution_pool.insert_signature(
                int(msg.slot), bytes(msg.beacon_block_root),
                pos // sub_size, pos % sub_size, bytes(msg.signature),
            )

    def process_sync_committee_message(self, msg) -> None:
        """Verify and pool one ``SyncCommitteeMessage`` (reference
        ``sync_committee_verification.rs`` gossip checks: committee
        membership + signature over the block root)."""
        from ..crypto.bls import api as bls

        positions, sig_set = self._preverify_sync_message(msg, self.head_state)
        from .. import device_pipeline

        with device_pipeline.work_context("sync_committee"):
            ok = bls.verify_signature_sets([sig_set])
        if not ok:
            raise AttestationError("bad sync committee message signature")
        self._pool_sync_message(msg, positions)

    def process_sync_committee_messages(self, messages) -> List[Optional[str]]:
        """Batch path (the POST pool/sync_committees route): all signature
        sets verify in ONE backend call — the reference coalesces sync
        messages through the processor the same way as attestations; on a
        batch failure, fall back per item.  Returns one error string or
        None per message."""
        from ..crypto.bls import api as bls

        state = self.head_state
        prepared = []
        results: List[Optional[str]] = []
        for msg in messages:
            try:
                positions, sig_set = self._preverify_sync_message(msg, state)
                prepared.append((msg, positions, sig_set))
                results.append(None)
            except AttestationError as e:
                prepared.append(None)
                results.append(str(e))
        live = [p for p in prepared if p is not None]
        if not live:
            return results
        from .. import device_pipeline

        with device_pipeline.work_context("sync_committee"):
            batch_ok = bls.verify_signature_sets([p[2] for p in live])
        for i, p in enumerate(prepared):
            if p is None:
                continue
            msg, positions, sig_set = p
            ok = batch_ok or bls.verify_signature_sets([sig_set])
            if not ok:
                results[i] = "bad sync committee message signature"
                continue
            self._pool_sync_message(msg, positions)
        return results

    def _preverify_signed_contribution(self, signed_contribution):
        """Spec checks for a ``SignedContributionAndProof`` — the full gossip
        rule set (reference ``verify_sync_committee_contribution``): the
        aggregator must be in the contribution's subcommittee AND pass the
        sync-aggregator selection gate; THREE signature sets (selection
        proof, outer signature, contribution participants) are returned
        unverified for the batch entry points."""
        import hashlib

        from ..consensus import signature_sets as sets
        from ..crypto.bls import api as bls
        from ..types.spec import DOMAIN_SYNC_COMMITTEE

        state = self.head_state
        msg = signed_contribution.message
        contribution = msg.contribution
        aggregator = int(msg.aggregator_index)
        slot = int(contribution.slot)
        current_slot = self.current_slot()
        if not (current_slot - 1 <= slot <= current_slot + 1):
            raise AttestationError(
                f"contribution slot {slot} outside the current-slot window"
            )
        sub = int(contribution.subcommittee_index)
        if sub >= self.spec.sync_committee_subnet_count:
            raise AttestationError("subcommittee index out of range")
        if aggregator >= len(state.validators):
            raise AttestationError("aggregator index out of range")
        sub_size = self.sync_contribution_pool._sub_size()
        positions = self._sync_committee_positions(state, aggregator, slot=slot)
        if not any(p // sub_size == sub for p in positions):
            raise AttestationError("aggregator is not in the contribution's subcommittee")
        modulo = max(1, sub_size // self.spec.target_aggregators_per_sync_subcommittee)
        digest = hashlib.sha256(bytes(msg.selection_proof)).digest()
        if int.from_bytes(digest[:8], "little") % modulo != 0:
            raise AttestationError("validator is not a selected sync aggregator")

        committee = self._sync_committee_for_slot(state, slot)
        participants = [
            sets.pubkey_cache(bytes(committee.pubkeys[sub * sub_size + i]))
            for i, bit in enumerate(contribution.aggregation_bits)
            if bit
        ]
        if not participants:
            raise AttestationError("empty sync contribution")
        epoch = slot // self.spec.slots_per_epoch
        domain = h.get_domain(state, DOMAIN_SYNC_COMMITTEE, epoch, self.spec)
        signing_root = h.compute_signing_root(
            bytes(contribution.beacon_block_root), domain
        )
        try:
            sig_sets = [
                sets.sync_selection_proof_signature_set(
                    state, aggregator, slot, sub, msg.selection_proof,
                    self.types, self.spec,
                ),
                sets.contribution_and_proof_signature_set(
                    state, signed_contribution, self.spec
                ),
                bls.SignatureSet(
                    sets._sig(bytes(contribution.signature)),
                    signing_root, participants,
                ),
            ]
        except bls.BlsError as e:
            raise AttestationError(f"malformed contribution signature: {e}") from e
        return contribution, sig_sets

    def process_signed_contribution(self, signed_contribution) -> None:
        from ..crypto.bls import api as bls

        contribution, sig_sets = self._preverify_signed_contribution(signed_contribution)
        from .. import device_pipeline

        with device_pipeline.work_context("sync_committee"):
            ok = bls.verify_signature_sets(sig_sets)
        if not ok:
            raise AttestationError("bad sync contribution signature(s)")
        self.sync_contribution_pool.insert_contribution(contribution)

    # ------------------------------------------------- pool-operation gossip
    #
    # Reference gossip_methods.rs process_gossip_{voluntary_exit,
    # proposer_slashing, attester_slashing, bls_to_execution_change}:
    # dedup via the observed cache (IGNORE — return False, no forward),
    # verify signatures through the BACKEND batch seam and apply on a
    # head-state scratch (REJECT — raise ChainError, penalize), then pool.
    # One table-driven body: the dedup key, signature-set builder,
    # processor, and pool insert are the only per-kind parts — and the
    # observe-after-verify discipline (an invalid op must never censor the
    # validator's real one, observed_operations.rs) is enforced ONCE.

    def _on_gossip_op(self, kind: str, op, key, sets_fn, process_fn,
                      insert_fn, what: str, scratch=None) -> bool:
        from ..crypto.bls import api as bls

        if self.observed.operations.is_known(kind, key):
            return False
        if scratch is None:
            scratch = self.head_state.copy()
        try:
            sig_sets = sets_fn(scratch)
        except Exception as e:
            raise ChainError(f"invalid {what}: {e}") from e
        if not bls.verify_signature_sets(list(sig_sets)):
            raise ChainError(f"invalid {what}: bad signature")
        try:
            process_fn(scratch)
        except Exception as e:
            raise ChainError(f"invalid {what}: {e}") from e
        self.observed.operations.observe(kind, key)
        insert_fn()
        return True

    def on_gossip_voluntary_exit(self, exit_) -> bool:
        from ..consensus import signature_sets as sets
        from ..consensus.per_block import process_voluntary_exit
        from . import events as ev

        def insert():
            self.op_pool.insert_voluntary_exit(exit_)
            self.events.publish(ev.TOPIC_EXIT, ev.exit_event_payload(exit_))

        return self._on_gossip_op(
            "voluntary_exit", exit_, int(exit_.message.validator_index),
            lambda st: [sets.voluntary_exit_signature_set(st, exit_, self.spec)],
            lambda st: process_voluntary_exit(
                st, exit_, self.types, self.spec, verify=False),
            insert, "voluntary exit",
        )

    def on_gossip_proposer_slashing(self, slashing) -> bool:
        from ..consensus import signature_sets as sets
        from ..consensus.per_block import process_proposer_slashing

        return self._on_gossip_op(
            "proposer_slashing", slashing,
            int(slashing.signed_header_1.message.proposer_index),
            lambda st: sets.proposer_slashing_signature_sets(
                st, slashing, self.spec),
            lambda st: process_proposer_slashing(
                st, slashing, self.types, self.spec, False),
            lambda: self.op_pool.insert_proposer_slashing(slashing),
            "proposer slashing",
        )

    def on_gossip_attester_slashing(self, slashing) -> bool:
        from ..consensus import signature_sets as sets
        from ..consensus.per_block import process_attester_slashing

        def insert():
            self.op_pool.insert_attester_slashing(slashing)
            # A verified slashing is proof of equivocation: strip the
            # offenders' fork-choice weight NOW, without waiting for block
            # inclusion (reference beacon_chain.rs
            # verify_attester_slashing_for_gossip -> fc.on_attester_slashing).
            self.fork_choice.on_attester_slashing(
                attester_slashing_indices(slashing))

        return self._on_gossip_op(
            "attester_slashing", slashing, slashing.hash_tree_root(),
            lambda st: sets.attester_slashing_signature_sets(
                st, slashing, self.spec),
            lambda st: process_attester_slashing(
                st, slashing, self.types, self.spec, False),
            insert,
            "attester slashing",
        )

    def on_gossip_bls_change(self, signed_change, scratch=None) -> bool:
        """``scratch``: batch callers (the HTTP route) pass ONE shared
        scratch state so N changes cost one head-state copy, not N — and
        later items validate against the post-earlier-items state, the
        batch-application semantics."""
        from ..consensus import signature_sets as sets
        from ..consensus.per_block import process_bls_to_execution_change

        return self._on_gossip_op(
            "bls_to_execution_change", signed_change,
            int(signed_change.message.validator_index),
            lambda st: [sets.bls_to_execution_change_signature_set(
                st, signed_change, self.spec)],
            lambda st: process_bls_to_execution_change(
                st, signed_change, self.types, self.spec, False),
            lambda: self.op_pool.insert_bls_to_execution_change(signed_change),
            "bls change", scratch=scratch,
        )

    def process_signed_contributions(self, signed_contributions) -> List[Optional[str]]:
        """Batch path for POST contribution_and_proofs: every contribution's
        3 signature sets verify in ONE backend call, with the per-item
        fidelity fallback.  Returns one error string or None per item."""
        from ..crypto.bls import api as bls

        prepared = []
        results: List[Optional[str]] = []
        for signed in signed_contributions:
            try:
                prepared.append(self._preverify_signed_contribution(signed))
                results.append(None)
            except AttestationError as e:
                prepared.append(None)
                results.append(str(e))
        live = [p for p in prepared if p is not None]
        if not live:
            return results
        from .. import device_pipeline

        with device_pipeline.work_context("sync_committee"):
            batch_ok = bls.verify_signature_sets(
                [s for p in live for s in p[1]])
        for i, p in enumerate(prepared):
            if p is None:
                continue
            contribution, sig_sets = p
            ok = batch_ok or bls.verify_signature_sets(sig_sets)
            if not ok:
                results[i] = "bad sync contribution signature(s)"
                continue
            self.sync_contribution_pool.insert_contribution(contribution)
            # SSE contribution_and_proof (reference events.rs): verified
            # contributions stream to subscribers
            from . import events as ev

            self.events.publish(ev.TOPIC_CONTRIBUTION_AND_PROOF, {
                "slot": str(int(contribution.slot)),
                "beacon_block_root": "0x" + bytes(
                    contribution.beacon_block_root).hex(),
                "subcommittee_index": str(int(contribution.subcommittee_index)),
            })
        return results

    def apply_verified_aggregate(self, cand: "AggregateCandidate") -> None:
        """Apply a signature-verified aggregate candidate: fork choice + pool
        via the inner attestation, then record (aggregate root, aggregator)
        in the observed caches.  The ONE place the observe sequence lives —
        both the gossip router and the HTTP publish path call this."""
        self.apply_attestation(cand.inner)
        self.observed.aggregates.observe(
            int(cand.inner.attestation.data.slot),
            cand.inner.attestation.hash_tree_root(),
        )
        self.observed.aggregators.observe(
            int(cand.inner.attestation.data.target.epoch),
            int(cand.signed_aggregate.message.aggregator_index),
        )

    def process_aggregate(self, signed_aggregate) -> None:
        """Fully verify and apply one SignedAggregateAndProof (batch-of-one;
        the gossip router batches many candidates into one device program)."""
        from ..crypto.bls import api as bls

        cand = self.preverify_aggregate(signed_aggregate)
        from .. import device_pipeline

        with device_pipeline.work_context("gossip_aggregate"):
            ok = bls.verify_signature_sets(cand.signature_sets)
        if not ok:
            raise AttestationError("bad aggregate signature(s)")
        self.apply_verified_aggregate(cand)

    def apply_attestation(self, cand: "AttestationCandidate",
                          is_from_block: bool = False) -> None:
        """Apply an already-signature-verified candidate to fork choice and
        the aggregation pool, and record it in the observed caches."""
        data = cand.attestation.data
        if not is_from_block:
            # Slot-relative attestation delay (reference unagg/agg delay
            # histograms): how late after ITS slot's start this attestation
            # reached fork choice.  Block-carried attestations are
            # historical by construction and would only skew the figure.
            metrics.ATTESTATION_ARRIVAL_DELAY_SECONDS.observe(max(
                0.0,
                self.slot_clock._seconds()
                - self.slot_clock.start_of(int(data.slot)),
            ))
        self.fork_choice.on_attestation(
            current_slot=self.current_slot(),
            attestation_slot=int(data.slot),
            attesting_indices=list(cand.indexed.attesting_indices),
            beacon_block_root=bytes(data.beacon_block_root),
            target_epoch=int(data.target.epoch),
            target_root=bytes(data.target.root),
            is_from_block=is_from_block,
        )
        self.attestation_pool.insert(cand.attestation)
        # Observe only single-attester (unaggregated) items: recording every
        # index of an aggregate would later drop the validators' own subnet
        # attestations as "already seen" and starve downstream aggregation.
        if len(cand.indexed.attesting_indices) == 1:
            self.observed.attesters.observe(
                int(data.target.epoch), int(cand.indexed.attesting_indices[0])
            )

    def process_attestation(self, attestation, is_from_block: bool = False) -> None:
        """Verify an unaggregated/aggregated attestation (signature + spec
        checks against the target's state) and apply it to fork choice + the
        aggregation pool (reference ``attestation_verification.rs`` +
        ``beacon_chain.rs:2139``).  Batch-of-one through the active backend —
        the gossip router uses preverify/apply directly to verify whole
        drained batches in one device program."""
        from ..crypto.bls import api as bls

        cand = self.preverify_attestation(attestation)
        from .. import device_pipeline

        with device_pipeline.work_context("gossip_attestation"):
            ok = bls.verify_signature_sets([cand.signature_set])
        if not ok:
            raise AttestationError("bad attestation signature")
        self.apply_attestation(cand, is_from_block)

    # ----------------------------------------------------------- production

    def state_at_slot(self, slot: int, block_root: Optional[bytes] = None):
        """State at ``block_root`` (default: head) advanced with empty slots
        to ``slot`` — served from the pre-advanced cache when the
        state-advance timer already did the work (reference
        ``state_advance_timer.rs``: the expensive epoch-boundary advance
        happens at tail-of-slot, not on the production/attestation path)."""
        root = self.head_root if block_root is None else block_root
        cached = self._advanced
        if cached is not None and cached[0] == root and cached[1] == slot:
            self._advance_hits += 1
            # defensive copy: callers mutate production pre-states
            return cached[2].copy(), root
        state = self.get_state(root)
        if state is None:
            raise ChainError(f"unknown block root {root.hex()[:16]}")
        if int(state.slot) > slot:
            raise ChainError(f"state {state.slot} is past requested slot {slot}")
        if int(state.slot) == slot:
            return state, root
        state = state.copy()
        state = process_slots(state, slot, self.types, self.spec)
        return state, root

    def prepare_next_slot(self) -> bool:
        """Pre-advance the head state to the NEXT slot (the tail-of-slot
        job the reference's state_advance_timer runs): block production and
        attestation at the next slot then start from a cached state instead
        of paying the advance — the epoch-boundary case is the one that
        matters (full epoch processing).  Returns True when work was done.

        A head more than ``MAX_ADVANCE_DISTANCE`` slots behind the clock is
        not advanced (the reference's ``state_advance_timer.rs``): a node
        syncing, or booted from an old anchor, would otherwise process slot
        after slot up to the clock.  The JAX package's copy has no such
        guard."""
        current_slot = self.current_slot()
        if current_slot - self.head_slot() > MAX_ADVANCE_DISTANCE:
            return False
        next_slot = current_slot + 1
        head_root = self.head_root
        cached = self._advanced
        if cached is not None and cached[0] == head_root and cached[1] == next_slot:
            return False
        state = self.get_state(head_root)
        if state is None or int(state.slot) >= next_slot:
            return False
        with tracing.span("state_advance", hist=metrics.STATE_ADVANCE_SECONDS):
            advanced = process_slots(
                state.copy(), next_slot, self.types, self.spec
            )
        self._advanced = (head_root, next_slot, advanced)
        return True

    def produce_block(
        self,
        slot: int,
        randao_reveal: bytes,
        graffiti: bytes = b"\x00" * 32,
        sync_aggregate=None,
        parent_root: Optional[bytes] = None,
        pre_state=None,
        blob_kzg_commitments: Optional[List[bytes]] = None,
        payload_header=None,
        execution_requests=None,
    ):
        """Assemble an unsigned block on the current head (or on
        ``parent_root`` — how tests build forks); reference
        ``produce_block_with_verification:4137`` → ``produce_block_on_state:4720``.
        ``pre_state``: the already-slot-advanced state for (parent_root, slot)
        if the caller has it (avoids re-advancing); it will be mutated.
        Returns ``(block, post_state_root)``; caller signs."""
        types, spec = self.types, self.spec
        # Graffiti precedence (graffiti_calculator.rs): VC-provided wins;
        # otherwise operator flag, then the calculated EL+CL version string.
        graffiti = self.graffiti_calculator.get_graffiti(graffiti)
        if pre_state is not None:
            if parent_root is None:
                raise ChainError("pre_state requires an explicit parent_root")
            state = pre_state
            if int(state.slot) != slot:
                raise ChainError(f"pre_state at slot {state.slot}, expected {slot}")
        else:
            if parent_root is None:
                parent_root = self._maybe_re_org_parent(slot)
            state, parent_root = self.state_at_slot(slot, parent_root)
        if state is self._states.get(parent_root):
            state = state.copy()
        fork = type(state).fork_name
        proposer = h.get_beacon_proposer_index(state, spec)

        # Mature naive-pool aggregates into the op pool, then max-cover pack
        # (reference: produce_block_on_state → op_pool.get_attestations).
        for att in self.attestation_pool.get_for_block(state, spec, 10_000):
            self.op_pool.insert_attestation(att)
        max_atts = (
            spec.preset.max_attestations_electra
            if fork == "electra"
            else spec.preset.max_attestations
        )
        attestations = self.op_pool.get_attestations(state, types, spec, max_atts)
        proposer_slashings, attester_slashings = self.op_pool.get_slashings(
            state, spec, types
        )

        # MEV path: a builder payload HEADER yields a blinded block
        # (reference produce_block's BlindedPayload variant).
        blinded = payload_header is not None
        # Eth1 vote + required deposits (reference eth1_chain.rs): without a
        # follower, repeat the state's current eth1_data and carry none.
        eth1_data = state.eth1_data.copy()
        deposits = []
        if self.eth1_service is not None:
            try:
                eth1_data = self.eth1_service.eth1_vote(state)
                # will THIS vote flip state.eth1_data? (process_eth1_data
                # runs before process_operations in the transition)
                period_slots = (spec.preset.epochs_per_eth1_voting_period
                                * spec.slots_per_epoch)
                same = sum(1 for v in state.eth1_data_votes if v == eth1_data) + 1
                effective = eth1_data if same * 2 > period_slots else state.eth1_data
                deposits = self.eth1_service.deposits_for_block(state, effective)
            except Exception:
                eth1_data = state.eth1_data.copy()
                deposits = []

        body_cls = types.blinded_block_body[fork] if blinded else types.block_body[fork]
        body_kwargs = dict(
            randao_reveal=randao_reveal,
            eth1_data=eth1_data,
            graffiti=graffiti,
            proposer_slashings=proposer_slashings,
            attester_slashings=attester_slashings,
            attestations=attestations,
            deposits=deposits,
            voluntary_exits=self.op_pool.get_voluntary_exits(state, types, spec),
        )
        if hasattr(body_cls, "fields") and "sync_aggregate" in body_cls.fields:
            if sync_aggregate is None:
                # The pool's contributions for the PREVIOUS slot over the
                # parent root are exactly what a block at ``slot`` carries
                # (produce_block_on_state → op_pool sync contributions).
                pooled = self.sync_contribution_pool.best_sync_aggregate(
                    max(slot, 1) - 1, parent_root
                )
                if any(pooled.sync_committee_bits):
                    sync_aggregate = pooled
            if sync_aggregate is None:
                from ..crypto.bls import api as bls

                sync_aggregate = types.SyncAggregate(
                    sync_committee_bits=[False] * spec.preset.sync_committee_size,
                    sync_committee_signature=bls.INFINITY_SIGNATURE,
                )
            body_kwargs["sync_aggregate"] = sync_aggregate
        if "execution_payload_header" in body_cls.fields:
            body_kwargs["execution_payload_header"] = payload_header
        if "execution_payload" in body_cls.fields:
            fee_recipient = self.proposer_preparations.get(proposer)
            if fork == "electra" and hasattr(
                self.execution_engine, "produce_payload_and_requests"
            ):
                payload, requests = self.execution_engine.produce_payload_and_requests(
                    state, types, spec, suggested_fee_recipient=fee_recipient
                )
                body_kwargs["execution_payload"] = payload
                body_kwargs["execution_requests"] = requests
            else:
                # the prepared recipient rides the payload attributes (the
                # EL's block hash commits to it)
                body_kwargs["execution_payload"] = self.execution_engine.produce_payload(
                    state, types, spec, suggested_fee_recipient=fee_recipient
                )
        if "bls_to_execution_changes" in body_cls.fields:
            body_kwargs["bls_to_execution_changes"] = (
                self.op_pool.get_bls_to_execution_changes(state, spec)
            )
        if "blob_kzg_commitments" in body_cls.fields:
            body_kwargs["blob_kzg_commitments"] = list(blob_kzg_commitments or [])
        if "execution_requests" in body_cls.fields and "execution_requests" not in body_kwargs:
            if execution_requests is not None:
                # blinded electra production: requests come from the bid
                body_kwargs["execution_requests"] = execution_requests
            else:
                # mock-EL path: no EL-triggered requests
                body_kwargs["execution_requests"] = types.ExecutionRequests(
                    deposits=[], withdrawals=[], consolidations=[]
                )

        block_cls = types.blinded_block[fork] if blinded else types.block[fork]
        block = block_cls(
            slot=slot,
            proposer_index=proposer,
            parent_root=parent_root,
            state_root=b"\x00" * 32,
            body=body_cls(**body_kwargs),
        )

        # Dry-run the block on the state to compute the post-state root
        # (reference: per_block_processing(VerifyRandao) dry run; signatures
        # are the caller's and randao is verified at import).
        signed_cls = (types.signed_blinded_block[fork] if blinded
                      else types.signed_block[fork])
        wrapper = signed_cls(message=block, signature=b"\x00" * 96)
        from ..consensus.per_block import per_block_processing

        per_block_processing(
            state,
            wrapper,
            types,
            spec,
            strategy=BlockSignatureStrategy.NO_VERIFICATION,
            verify_block_root=False,
            payload_verifier=None,
        )
        block.state_root = state.hash_tree_root()
        return block, bytes(block.state_root)

    # ------------------------------------------------------- MEV / builder

    def produce_blinded_block(self, slot: int, randao_reveal: bytes,
                              graffiti: bytes = b"\x00" * 32):
        """Builder-path production (reference ``produce_block`` blinded
        variant): fetch a bid from the configured relay, verify the bid
        signature and header consistency, build a BLINDED block around the
        header.  Raises ``ChainError`` when no usable bid exists — the
        caller (HTTP route / VC) falls back to local production."""
        from ..consensus.per_block import is_merge_transition_complete
        from ..crypto.bls import api as bls
        from ..execution_layer.builder_client import (
            BuilderError,
            builder_signing_root,
        )

        if self.builder is None:
            raise ChainError("no builder configured")
        state, parent_root = self.state_at_slot(slot)
        if not hasattr(state, "latest_execution_payload_header") or (
            not is_merge_transition_complete(state)
        ):
            raise ChainError("builder path requires post-merge execution")
        parent_hash = bytes(state.latest_execution_payload_header.block_hash)
        proposer = h.get_beacon_proposer_index(state, self.spec)
        pubkey = bytes(state.validators[proposer].pubkey)
        try:
            fork, signed_bid = self.builder.get_header(slot, parent_hash, pubkey,
                                                       self.types)
        except BuilderError as e:
            raise ChainError(f"builder get_header failed: {e}") from e
        if signed_bid is None:
            raise ChainError("builder returned no bid")
        if fork != type(state).fork_name:
            # a wrong-fork header would poison the state header field and
            # surface later as a non-ChainError, defeating the fallback
            raise ChainError(
                f"builder bid fork {fork!r} != state fork {type(state).fork_name!r}"
            )
        bid = signed_bid.message
        if int(bid.value) == 0:
            raise ChainError("builder bid has zero value")
        if bytes(bid.header.parent_hash) != parent_hash:
            raise ChainError("builder bid builds on the wrong parent")
        if self.builder_pubkey is not None and (
            bytes(bid.pubkey) != bytes(self.builder_pubkey)
        ):
            # Without a pinned identity the signature below only proves
            # internal consistency (bid.pubkey is attacker-chosen over plain
            # http); pinning is how the operator makes it an AUTH check.
            raise ChainError("builder bid signed by an unexpected relay key")
        sig_set = bls.SignatureSet.single_pubkey(
            bls.Signature.from_bytes(bytes(signed_bid.signature)),
            bls.PublicKey.from_bytes(bytes(bid.pubkey)),
            builder_signing_root(bid.hash_tree_root(), self.spec),
        )
        if not bls.verify_signature_sets([sig_set]):
            raise ChainError("builder bid signature invalid")
        blob_commitments = list(getattr(bid, "blob_kzg_commitments", []) or [])
        # electra bids carry the EL-triggered requests the blinded body must
        # embed (builder_bid.rs:14-35 + builder-specs electra).
        bid_requests = getattr(bid, "execution_requests", None)
        return self.produce_block(
            slot, randao_reveal, graffiti=graffiti,
            parent_root=parent_root, pre_state=state,
            payload_header=bid.header.copy(),
            blob_kzg_commitments=blob_commitments or None,
            execution_requests=bid_requests.copy() if bid_requests is not None else None,
        )

    def unblind_and_import(self, signed_blinded_block):
        """POST /eth/v1/beacon/blinded_blocks: reveal the payload at the
        relay, reconstruct the full block (same root — the header summarizes
        the payload), import it.  Returns (block_root, signed_full_block)."""
        from ..consensus.per_block import execution_payload_to_header
        from ..execution_layer.builder_client import BuilderError

        if self.builder is None:
            raise ChainError("no builder configured")
        fork = type(signed_blinded_block.message).fork_name
        try:
            payload = self.builder.submit_blinded_block(
                signed_blinded_block, self.types
            )
        except BuilderError as e:
            raise BlockError(f"builder failed to reveal payload: {e}") from e
        header = signed_blinded_block.message.body.execution_payload_header
        rebuilt = execution_payload_to_header(payload, self.types, fork)
        if rebuilt.hash_tree_root() != header.hash_tree_root():
            raise BlockError("revealed payload does not match the signed header")
        blinded = signed_blinded_block.message
        body_kwargs = {}
        for name in blinded.body.fields:
            if name == "execution_payload_header":
                body_kwargs["execution_payload"] = payload
            else:
                body_kwargs[name] = getattr(blinded.body, name)
        full = self.types.block[fork](
            slot=blinded.slot,
            proposer_index=blinded.proposer_index,
            parent_root=blinded.parent_root,
            state_root=blinded.state_root,
            body=self.types.block_body[fork](**body_kwargs),
        )
        signed_full = self.types.signed_block[fork](
            message=full, signature=signed_blinded_block.signature
        )
        root = self.process_block(signed_full)
        return root, signed_full

    def _maybe_re_org_parent(self, slot: int) -> Optional[bytes]:
        """Proposer late-block re-org decision (reference
        ``beacon_chain.rs:4250`` ``get_state_for_re_org``): when the head is
        a weakly-attested late block, propose on its PARENT and orphan it.
        Returns the parent root to build on, or None for the canonical head.
        Only attempted early in the slot (within 1/re_org_cutoff_denominator
        of slot time — a re-org block proposed late loses the race it is
        trying to win)."""
        from ..fork_choice.fork_choice import DoNotReOrg

        if self.re_org_head_threshold is None:
            return None
        into_slot = self.slot_clock.seconds_from_current_slot_start()
        if into_slot is not None and into_slot > (
            self.spec.seconds_per_slot / self.re_org_cutoff_denominator
        ):
            return None
        # head_late gate (beacon_chain.rs:4289-4290): only a head that
        # arrived AFTER the attestation deadline (seconds_per_slot/3) may be
        # orphaned — a timely block that is merely weakly attested (slow
        # attestation propagation, low participation) must be left alone.
        head_delay = self._block_delays.get(self.head_root)
        if head_delay is None or head_delay <= self.spec.seconds_per_slot / 3:
            return None
        try:
            parent = self.fork_choice.get_proposer_head(
                int(slot), self.head_root,
                re_org_head_threshold=self.re_org_head_threshold,
                re_org_parent_threshold=self.re_org_parent_threshold,
                max_epochs_since_finalization=(
                    self.re_org_max_epochs_since_finalization),
                disallowed_offsets=self.re_org_disallowed_offsets,
            )
        except DoNotReOrg as e:
            log.debug("not re-orging: %s", e)
            return None
        log.info("attempting late-block re-org: building on parent %s",
                 parent.hex()[:12])
        return parent

    def produce_attestation_data(self, slot: int, committee_index: int):
        """Reference ``produce_unaggregated_attestation:1759`` — the data all
        committee members at (slot, index) sign.  The early-attester cache is
        consulted first: for the newest verified block it answers without
        touching (or advancing) the head state."""
        types, spec = self.types, self.spec
        early = self.early_attester_cache.try_attest(
            int(slot), int(committee_index), types, spec
        )
        if early is not None:
            # The newest verified block is the right attestation target even
            # before the head recompute lands (the reference returns here
            # unconditionally; the cache is cleared if a re-org ever picks a
            # different branch).
            return early
        state = self.head_state
        head_root = self.head_root
        if int(state.slot) < slot:
            state, _ = self.state_at_slot(slot)
        epoch = h.compute_epoch_at_slot(slot, spec)
        epoch_start = h.compute_start_slot_at_epoch(epoch, spec)
        if self._blocks_slot(head_root) <= epoch_start:
            target_root = head_root  # head at/before the boundary is the target
        else:
            target_root = h.get_block_root(state, epoch, spec)
        # EIP-7549: post-electra the data's index is always 0 — the committee
        # is conveyed by the attestation's committee_bits instead.
        data_index = (
            0 if spec.fork_name_at_slot(slot) == "electra" else committee_index
        )
        return types.AttestationData(
            slot=slot,
            index=data_index,
            beacon_block_root=head_root,
            source=state.current_justified_checkpoint.copy(),
            target=types.Checkpoint(epoch=epoch, root=target_root),
        )

    def _blocks_slot(self, block_root: bytes) -> int:
        if block_root == self.genesis_block_root:
            return int(self.genesis_state.slot)
        # Raw stored form only: a blinded block's slot is right there in the
        # header, and this lookup must work while the EL is down (payload
        # reconstruction would raise exactly then).
        block = self._raw_block(block_root)
        if block is None:
            raise ChainError(f"unknown block {block_root.hex()[:16]}")
        return int(block.message.slot)

    def is_pre_finalization_block(self, block_root: bytes) -> bool:
        """Is an (unknown-to-fork-choice) root a pre-finalization block?
        True -> attestations to it are rejected outright; False -> a
        single-block lookup is warranted (reference
        pre_finalization_cache.rs ``is_pre_finalization_block``)."""
        return self.pre_finalization_cache.check(block_root, self)

    def reset_fork_choice_to_finalization(self) -> None:
        """Swap in a fork choice rebuilt from the finalized checkpoint by
        canonical replay (reference fork_revert.rs
        ``reset_fork_choice_to_finalization``) — the recovery path for a
        corrupt or unsound persisted fork choice.  Destructive: every
        non-canonical branch is forgotten."""
        from .fork_revert import reset_fork_choice_to_finalization

        self.fork_choice = reset_fork_choice_to_finalization(self)
        self.recompute_head()

    # ----------------------------------------------------------------- head

    def recompute_head(self) -> bytes:
        """Reference ``canonical_head.rs:496`` ``recompute_head_at_slot``."""
        with tracing.span("head_recompute", hist=metrics.HEAD_RECOMPUTE_SECONDS):
            return self._recompute_head_inner()

    def _recompute_head_inner(self) -> bytes:
        old_head = self.head_root
        head = self.fork_choice.get_head(self.current_slot())
        self.head_root = head
        # A head that re-orged away from the early-attester item makes the
        # cached attestation data wrong — drop it (reference clears the
        # cache on re-org in canonical_head.rs).  Atomic under the cache
        # lock: a concurrent add_head_block for this very head must not be
        # wiped by a stale compare-then-clear.
        self.early_attester_cache.clear_unless(head)
        if head != old_head:
            # Head swap vs re-org: a re-org abandons the old head's branch
            # (reference canonical_head.rs logs these distinctly).
            if self.fork_choice.is_descendant(old_head, head):
                log.info("new head", slot=self._blocks_slot(head),
                         root="0x" + head.hex()[:16])
            else:
                log.warning(
                    "head re-org",
                    old_root="0x" + old_head.hex()[:16],
                    old_slot=self._blocks_slot(old_head),
                    new_root="0x" + head.hex()[:16],
                    new_slot=self._blocks_slot(head),
                )
        st = self.get_state(head) if head != old_head else None
        if st is not None:
            old_epoch = self._blocks_slot(old_head) // self.spec.slots_per_epoch
            new_epoch = self._blocks_slot(head) // self.spec.slots_per_epoch
            self.events.head(
                slot=self._blocks_slot(head),
                block_root=head,
                state_root=bytes(self._blocks[head].message.state_root)
                if head in self._blocks
                else st.hash_tree_root(),
                epoch_transition=new_epoch > old_epoch,
            )
        # Real ELs track our head (engine_forkchoiceUpdated on head change);
        # the in-proc mock has no such method and is skipped.
        if head != old_head and hasattr(self.execution_engine, "notify_forkchoice_updated"):
            st2 = self.get_state(head)
            if st2 is not None and hasattr(st2, "latest_execution_payload_header"):
                f_root_now = self.fork_choice.finalized_checkpoint[1]
                f_state = self._states.get(f_root_now)
                f_hash = (
                    bytes(f_state.latest_execution_payload_header.block_hash)
                    if f_state is not None
                    and hasattr(f_state, "latest_execution_payload_header")
                    else b"\x00" * 32
                )
                try:
                    self.execution_engine.notify_forkchoice_updated(
                        head_block_hash=bytes(
                            st2.latest_execution_payload_header.block_hash
                        ),
                        finalized_block_hash=f_hash,
                        fork=type(st2).fork_name,
                    )
                except Exception:
                    pass  # EL hiccups must never block head updates
        f_epoch, f_root = self.fork_choice.finalized_checkpoint
        if f_epoch > self._last_finalized_epoch:
            self._last_finalized_epoch = f_epoch
            log.info("finalized checkpoint advanced", epoch=f_epoch,
                     root="0x" + f_root.hex()[:16])
            f_state = self._states.get(f_root)
            self.events.finalized(
                epoch=f_epoch,
                block_root=f_root,
                state_root=bytes(self._blocks[f_root].message.state_root)
                if f_root in self._blocks
                else (f_state.hash_tree_root() if f_state is not None else b"\x00" * 32),
            )
        self._maybe_migrate()
        return head

    def _maybe_migrate(self) -> None:
        """Freeze newly-finalized history and drop abandoned forks from the
        object caches (reference: background ``migrate.rs`` — synchronous
        here; the networked node runs it off the hot path)."""
        f_epoch, f_root = self.fork_choice.finalized_checkpoint
        f_slot = f_epoch * self.spec.slots_per_epoch
        if f_slot <= self._migrated_slot or f_root not in self._states:
            return
        fork_choice = self.fork_choice

        def canonical_root_at_slot(slot: int):
            # locked per-walk: prune() may rebuild the node array between
            # migration steps (holding the lock across the WHOLE migration
            # would park imports behind state I/O)
            return fork_choice.ancestor_at_slot(f_root, slot)

        def state_for_root(block_root: bytes):
            return self._states.get(block_root)

        # Forks not descending from the finalized root are dead.
        abandoned = [
            root
            for root in self._states
            if root != f_root
            and self._blocks_slot(root) <= f_slot
            and fork_choice.ancestor_at_slot(f_root, self._blocks_slot(root)) != root
        ]
        self.db.migrate(
            finalized_slot=f_slot,
            finalized_state=self._states[f_root],
            canonical_root_at_slot=canonical_root_at_slot,
            state_for_root=state_for_root,
            abandoned_state_roots=[
                bytes(self._blocks[r].message.state_root)
                for r in abandoned
                if r in self._blocks
            ],
        )
        log.info("hot->cold migration", finalized_slot=f_slot,
                 abandoned_forks=len(abandoned))
        # Prune object caches: keep finalized root and everything after it.
        for root in abandoned:
            self._states.pop(root, None)
            self._blocks.pop(root, None)
        for root in list(self._states):
            if root != f_root and self._blocks_slot(root) < f_slot:
                self._states.pop(root, None)
        self.fork_choice.prune()
        self._migrated_slot = f_slot

    def simulate_attestation(self) -> None:
        """Produce (but never publish) one committee-0 attestation for the
        current slot and hand it to the validator monitor for later scoring
        (reference ``attestation_simulator.rs``): a free per-slot measure of
        what OUR view would have voted, scored against the canonical chain
        once the truth for the slot is knowable.  Skipped while syncing
        (head > 2 epochs behind — old-state committees are a burden)."""
        slot = self.current_slot()
        tolerance = 2 * self.spec.slots_per_epoch
        if self._blocks_slot(self.head_root) + tolerance < slot:
            return
        try:
            data = self.produce_attestation_data(slot, 0)
        except Exception:
            return
        self.validator_monitor.set_unaggregated_attestation(slot, data)

    def per_slot_task(self) -> None:
        """Per-slot tick (reference ``timer`` → ``per_slot_task``)."""
        slot = self.current_slot()
        self.fork_choice.update_time(slot)
        self.recompute_head()
        self.simulate_attestation()
        from .otb_verification import verify_otbs

        try:
            verify_otbs(self)
        except Exception as e:  # an OTB sweep must never starve pruning
            log.warning("otb verification sweep failed", error=str(e)[:80])
        self.attestation_pool.prune(slot)
        self.sync_contribution_pool.prune(slot)
        self.op_pool.prune(self.head_state, self.spec, current_slot=slot)
        self.observed.prune(self.fork_choice.finalized_checkpoint[0],
                            self.spec.slots_per_epoch)
        self.validator_monitor.prune(slot // self.spec.slots_per_epoch)
        # Missed-block tracking (validator_monitor.rs): once a slot has
        # closed, a monitored expected proposer with no canonical block is
        # a missed proposal.  Judged at a FULL slot's lag — a block
        # routinely lands seconds into the next slot, and the once-per-slot
        # guard would make that false miss permanent.  The epoch-level
        # proposer cache keeps the last two slots of each epoch checkable
        # after the head advances into the next one.
        prev = slot - 2
        if self.validator_monitor.monitored and prev > 0:
            try:
                expected = self._expected_proposer(prev)
                if expected is not None:
                    canonical = self.block_root_at_slot(prev)
                    block_seen = (
                        canonical is not None
                        and self._blocks_slot(canonical) == prev
                    )
                    self.validator_monitor.on_proposal_outcome(
                        prev, expected, block_seen)
            except Exception:
                pass  # monitoring must never break the tick
        f_slot = self.fork_choice.finalized_checkpoint[0] * self.spec.slots_per_epoch
        self.da_checker.prune(f_slot)
        # Blob retention horizon (spec MIN_EPOCHS_FOR_BLOB_SIDECARS_REQUESTS):
        # drop sidecars for pruned forks immediately and canonical blobs once
        # they age out — otherwise 128KiB-per-blob storage grows forever.
        horizon_slot = slot - (
            self.spec.min_epochs_for_blob_sidecars_requests * self.spec.slots_per_epoch
        )
        for root in list(self._blob_sidecars):
            if root not in self._blocks:
                self._blob_sidecars.pop(root, None)
            elif int(self._blocks[root].message.slot) < horizon_slot:
                self._blob_sidecars.pop(root, None)
        # store-side retention (backfilled sidecars live in the DB only)
        try:
            self.db.prune_blobs(horizon_slot)
        except Exception:
            pass  # retention pruning must never break the slot tick

    # ------------------------------------------------------------- queries

    def finalized_checkpoint(self) -> Tuple[int, bytes]:
        return self.fork_choice.finalized_checkpoint

    def justified_checkpoint(self) -> Tuple[int, bytes]:
        return self.fork_choice.justified_checkpoint

    def block_root_at_slot(self, slot: int) -> Optional[bytes]:
        """Canonical chain block root at ``slot`` (walks from head)."""
        return self.fork_choice.ancestor_at_slot(self.head_root, slot)
