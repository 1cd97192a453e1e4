"""Router: gossip/RPC demux into chain work.

Equivalent of the reference's ``network/src/router.rs`` +
``network_beacon_processor/`` (gossip_methods.rs / rpc_methods.rs): decodes
typed messages, pushes them through the ``BeaconProcessor`` priority queues
as WorkEvents whose handlers call into the ``BeaconChain``, gates gossip
forwarding on validation outcome, serves BlocksByRange/BlocksByRoot from the
store, and reports misbehaving peers.

A copy of the JAX package's ``lighthouse_tpu/network/router.py``; it
verifies through the BLS API's selected backend, the port's ``"torch"`` on
the card by default.
"""

from __future__ import annotations

from typing import List, Optional

from .. import metrics, telemetry_scope, tracing
from ..chain.beacon_chain import AttestationError, BlockError, ChainError
from ..consensus import helpers as h
from ..scheduler import BeaconProcessor, ReprocessQueue, W, WorkEvent
from . import rpc as rpc_mod
from . import topics as topics_mod
from .peer_manager import PeerAction
from .service import NetworkService


class Router:
    def __init__(
        self,
        *,
        chain,
        service: NetworkService,
        processor: Optional[BeaconProcessor] = None,
        sync_manager=None,
        slasher=None,
        scope=None,
    ):
        self.chain = chain
        self.service = service
        # Node telemetry scope (telemetry_scope.TelemetryScope) — held as a
        # plain attribute because gossip handlers run on processor worker
        # threads, where the runner's contextvar activation is invisible.
        self.scope = scope
        self.processor = processor if processor is not None else BeaconProcessor(max_workers=2)
        self.sync = sync_manager
        self.slasher = slasher
        # Attestations referencing a not-yet-imported block are parked here
        # and re-queued the moment the chain imports that root (reference
        # work_reprocessing_queue.rs) — dropping them instead loses real
        # fork-choice weight after every partition heal, and makes block
        # content race the lookup that imports the missing fork.
        self.reprocess = ReprocessQueue(self.processor)
        chain.block_imported_hooks.append(self.reprocess.block_imported)
        # drop_during_sync enforcement: while range sync is running, stale
        # gossip (attestations/aggregates/contributions/LC updates) is
        # discarded at enqueue (reference beacon_processor lib.rs).  The
        # lambda reads self.sync dynamically — SyncManager attaches itself
        # to the router after construction.
        if self.processor.is_syncing is None:
            from .sync import SyncState

            self.processor.is_syncing = (
                lambda: self.sync is not None and self.sync.state == SyncState.SYNCING
            )
        service.on_gossip = self.on_gossip
        # Same handler, ctx-aware arity: the service prefers this hook and
        # hands us the envelope's propagated trace context as the 5th arg.
        service.on_gossip_ctx = self.on_gossip
        service.on_rpc_request = self.on_rpc_request
        service.on_peer_connected = self.on_peer_connected
        service.on_peer_disconnected = self.on_peer_disconnected
        state = chain.genesis_state
        self.fork_digest = topics_mod.fork_digest(state, b"")
        self.metadata = rpc_mod.MetaData(seq_number=0, attnets=0, syncnets=0)

    # ------------------------------------------------------------ status

    def local_status(self) -> rpc_mod.Status:
        f_epoch, f_root = self.chain.finalized_checkpoint()
        head_root = self.chain.head_root
        return rpc_mod.Status(
            fork_digest=self.fork_digest,
            finalized_root=f_root,
            finalized_epoch=f_epoch,
            head_root=head_root,
            head_slot=self.chain._blocks_slot(head_root),
        )

    def on_peer_connected(self, peer: str) -> None:
        """Dial Status at connect (reference: ``status_peer``) — from a
        worker, not the network loop (the request blocks on the reply)."""

        def do_status(_):
            try:
                chunks = self.service.request(peer, rpc_mod.STATUS, self.local_status())
            except rpc_mod.RpcError:
                return
            if chunks and chunks[0][0] == rpc_mod.SUCCESS:
                status = rpc_mod.Status.from_bytes(chunks[0][1])
                self._handle_peer_status(peer, status)

        self.processor.send(WorkEvent(work_type=W.STATUS, process=do_status))

    def on_peer_disconnected(self, peer: str) -> None:
        pass

    def _handle_peer_status(self, peer: str, status: rpc_mod.Status) -> None:
        if status.fork_digest != self.fork_digest:
            self.service.peer_manager.report(peer, PeerAction.LOW_TOLERANCE, "wrong fork")
            self.service.endpoint.disconnect(peer)
            return
        self.service.peer_manager._peer(peer).status = status
        if self.sync is not None:
            self.sync.on_peer_status(peer, status)

    # ------------------------------------------------------------ gossip

    def on_gossip(self, topic: str, uncompressed: bytes, compressed: bytes,
                  sender: str, trace_ctx: Optional[dict] = None) -> None:
        try:
            kind = topics_mod.GossipTopic.parse(topic).kind
        except ValueError:
            self.service.reject_gossip(sender, topic, "bad_topic")
            return
        if kind == topics_mod.BEACON_BLOCK:
            self.processor.send(
                WorkEvent(
                    work_type=W.GOSSIP_BLOCK,
                    process=lambda _: self._process_gossip_block(
                        topic, uncompressed, compressed, sender,
                        trace_ctx=trace_ctx,
                    ),
                )
            )
        elif kind.startswith(topics_mod.BLOB_SIDECAR_PREFIX):
            self.processor.send(
                WorkEvent(
                    work_type=W.GOSSIP_BLOB_SIDECAR,
                    process=lambda _: self._process_gossip_blob(
                        topic, uncompressed, compressed, sender
                    ),
                )
            )
        elif kind.startswith(topics_mod.BEACON_ATTESTATION_PREFIX) or kind == topics_mod.BEACON_AGGREGATE_AND_PROOF:
            wt = (
                W.GOSSIP_AGGREGATE
                if kind == topics_mod.BEACON_AGGREGATE_AND_PROOF
                else W.GOSSIP_ATTESTATION
            )
            item = (topic, uncompressed, compressed, sender)
            self.processor.send(
                WorkEvent(
                    work_type=wt,
                    process=lambda it: self._process_gossip_attestations([it]),
                    process_batch=self._process_gossip_attestations,
                    item=item,
                    drop_during_sync=True,
                )
            )
        elif kind in self._OP_WORK_TYPES:
            item = (kind, topic, uncompressed, compressed, sender)
            self.processor.send(
                WorkEvent(
                    work_type=self._OP_WORK_TYPES[kind],
                    process=lambda _=None, it=item: self._process_gossip_operation(*it),
                    # current-slot-scoped work is worthless mid-sync; pool ops
                    # (exits/slashings/changes) stay valid and are kept
                    drop_during_sync=(
                        kind == topics_mod.SYNC_COMMITTEE_CONTRIBUTION_AND_PROOF
                    ),
                )
            )
        elif kind in (topics_mod.LIGHT_CLIENT_FINALITY_UPDATE,
                      topics_mod.LIGHT_CLIENT_OPTIMISTIC_UPDATE):
            wt = (W.GOSSIP_LIGHT_CLIENT_FINALITY_UPDATE
                  if kind == topics_mod.LIGHT_CLIENT_FINALITY_UPDATE
                  else W.GOSSIP_LIGHT_CLIENT_OPTIMISTIC_UPDATE)
            item = (kind, topic, uncompressed, compressed, sender)
            self.processor.send(
                WorkEvent(
                    work_type=wt,
                    process=lambda _=None, it=item: self._process_gossip_lc_update(*it),
                    drop_during_sync=True,
                )
            )

    _OP_WORK_TYPES = {
        topics_mod.VOLUNTARY_EXIT: W.GOSSIP_VOLUNTARY_EXIT,
        topics_mod.PROPOSER_SLASHING: W.GOSSIP_PROPOSER_SLASHING,
        topics_mod.ATTESTER_SLASHING: W.GOSSIP_ATTESTER_SLASHING,
        topics_mod.BLS_TO_EXECUTION_CHANGE: W.GOSSIP_BLS_TO_EXECUTION_CHANGE,
        topics_mod.SYNC_COMMITTEE_CONTRIBUTION_AND_PROOF: W.GOSSIP_SYNC_CONTRIBUTION,
    }

    def _process_gossip_operation(self, kind: str, topic: str,
                                  uncompressed: bytes, compressed: bytes,
                                  sender: str) -> None:
        """Pool-operation gossip (reference gossip_methods.rs
        process_gossip_{voluntary_exit,proposer_slashing,attester_slashing,
        bls_to_execution_change} + process_gossip_sync_contribution):
        decode, verify via the chain (dedup -> drop; invalid -> penalize),
        pool, and forward only what validated fresh."""
        chain = self.chain
        try:
            if kind == topics_mod.VOLUNTARY_EXIT:
                op = chain.types.SignedVoluntaryExit.from_ssz_bytes(uncompressed)
                fresh = chain.on_gossip_voluntary_exit(op)
            elif kind == topics_mod.PROPOSER_SLASHING:
                op = chain.types.ProposerSlashing.from_ssz_bytes(uncompressed)
                fresh = chain.on_gossip_proposer_slashing(op)
            elif kind == topics_mod.ATTESTER_SLASHING:
                # electra slashings carry the EIP-7549 committee-spanning
                # container; the TOPIC's digest names the fork (wallclock
                # would misdecode cross-fork messages at the transition)
                digest = topics_mod.GossipTopic.parse(topic).fork_digest
                fork = topics_mod.fork_name_for_digest(
                    digest, bytes(chain.genesis_state.genesis_validators_root),
                    chain.spec,
                ) or chain.spec.fork_name_at_slot(chain.current_slot())
                cls = (chain.types.AttesterSlashingElectra
                       if fork == "electra" else chain.types.AttesterSlashing)
                op = cls.from_ssz_bytes(uncompressed)
                fresh = chain.on_gossip_attester_slashing(op)
            elif kind == topics_mod.BLS_TO_EXECUTION_CHANGE:
                op = chain.types.SignedBLSToExecutionChange.from_ssz_bytes(
                    uncompressed)
                fresh = chain.on_gossip_bls_change(op)
            else:  # sync contribution-and-proof
                signed = chain.types.SignedContributionAndProof.from_ssz_bytes(
                    uncompressed)
                (err,) = chain.process_signed_contributions([signed])
                if err is not None:
                    # IGNORE vs REJECT (p2p spec): a contribution outside
                    # the slot window is normal propagation lag, not peer
                    # misbehavior — penalizing it would bleed honest peers
                    if "outside the current-slot window" not in err:
                        self.service.reject_gossip(
                            sender, topic, "invalid_op", detail=err)
                    return
                fresh = True
        except ChainError as e:
            self.service.reject_gossip(
                sender, topic, "invalid_op", detail=str(e))
            return
        except Exception:
            self.service.reject_gossip(sender, topic, "undecodable")
            return
        if fresh:
            self.service.forward(topic, compressed, exclude=sender,
                                 uncompressed=uncompressed)

    def _process_gossip_block(
        self, topic: str, uncompressed: bytes, compressed: bytes, sender: str,
        trace_ctx: Optional[dict] = None,
    ) -> None:
        from .sync import decode_signed_block

        chain = self.chain
        try:
            signed = decode_signed_block(chain, uncompressed)
        except Exception:
            self.service.reject_gossip(sender, topic, "undecodable")
            return
        # Proposer dedup/equivocation gate before any state work; the cache
        # is only POPULATED after successful import (observe-after-verify),
        # so an attacker's junk block cannot brand the honest proposer an
        # equivocator (observed_block_producers.rs).
        block_root = signed.message.hash_tree_root()
        seen = chain.observed.block_producers.status(
            int(signed.message.slot), int(signed.message.proposer_index), block_root
        )
        if seen == "duplicate":
            return
        if seen == "equivocation":
            # the slasher wants exactly these (double proposal evidence)
            if self.slasher is not None:
                self.slasher.on_block(signed)
                self._drain_slasher()
            self.service.reject_gossip(sender, topic, "proposer_equivocation")
            return
        # Resume the publisher's trace context (if the envelope carried one)
        # as a fresh local root: the import tree joins the remote proposal
        # tree on remote_trace_id in the fleet artifact.
        with tracing.resume_remote(
                trace_ctx, "gossip_block_import",
                slot=int(signed.message.slot), root=block_root.hex(),
                sender=sender,
                node=self.scope.node_id if self.scope is not None else None):
            try:
                chain.process_block(signed)
            except BlockError as e:
                if "pending availability" in str(e):
                    # Blobs haven't arrived yet — the chain stashed the block
                    # in the DA checker; the blob handler completes the
                    # import.
                    return
                if "unknown parent" in str(e) and self.sync is not None:
                    # Don't penalize: we may simply be behind. But do NOT
                    # forward either — an unknown-parent block has passed no
                    # validation, so propagating it would relay junk (the
                    # reference queues it for reprocessing and only
                    # propagates validated blocks).
                    self.sync.on_unknown_parent(signed, sender)
                    return
                self.service.reject_gossip(
                    sender, topic, "invalid_block", detail=str(e))
                return
            chain.observed.block_producers.observe(
                int(signed.message.slot), int(signed.message.proposer_index),
                block_root
            )
            if self.slasher is not None:
                self.slasher.on_block(signed)
                self._drain_slasher()
            # Forward with the ORIGIN's trace context, not a fresh local
            # stamp — downstream nodes see the publisher's causal frame.
            self.service.forward(topic, compressed, exclude=sender,
                                 uncompressed=uncompressed,
                                 trace_ctx=trace_ctx)
            self._publish_light_client_updates()
        # Imported: journal the cross-node causal link.  Worker threads must
        # not append to the scope journal directly (ordering would depend on
        # thread interleaving) — defer, drained on the runner thread at the
        # next settle boundary.
        if self.scope is not None:
            link = None
            origin = trace_ctx.get("node") if trace_ctx else None
            if trace_ctx and trace_ctx.get("trace_id"):
                link = (trace_ctx.get("node"), int(trace_ctx.get("lamport") or 0))
                telemetry_scope.FLEET_TRACE_LINKS.inc(kind="remote-import")
            self.scope.defer(
                "fleet", "block_imported",
                {"slot": int(signed.message.slot), "root": block_root.hex(),
                 "origin": origin},
                link=link,
            )

    def _publish_light_client_updates(self) -> None:
        """Gossip newly-produced LC finality/optimistic updates (reference:
        the LC server publishes on the two light_client topics)."""
        fin, opt = self.chain.lc_cache.take_new_updates()
        if fin is not None:
            t = topics_mod.GossipTopic(
                self.fork_digest, topics_mod.LIGHT_CLIENT_FINALITY_UPDATE
            )
            self.service.publish(str(t), fin.as_ssz_bytes())
        if opt is not None:
            t = topics_mod.GossipTopic(
                self.fork_digest, topics_mod.LIGHT_CLIENT_OPTIMISTIC_UPDATE
            )
            self.service.publish(str(t), opt.as_ssz_bytes())

    def _process_gossip_lc_update(self, kind: str, topic: str,
                                  uncompressed: bytes, compressed: bytes,
                                  sender: str) -> None:
        """Light-client update gossip (reference
        light_client_{finality,optimistic}_update_verification.rs / p2p
        spec): a received update is valid iff it EQUALS the one this node's
        LC server computed from its own view — forward on match, IGNORE
        (no penalty: views can lag) otherwise."""
        cache = self.chain.lc_cache
        ours = (cache.latest_finality_update
                if kind == topics_mod.LIGHT_CLIENT_FINALITY_UPDATE
                else cache.latest_optimistic_update)
        if ours is None:
            return  # no local view to validate against: IGNORE
        if ours.as_ssz_bytes() == uncompressed:
            self.service.forward(topic, compressed, exclude=sender,
                                 uncompressed=uncompressed)

    def _process_gossip_blob(
        self, topic: str, uncompressed: bytes, compressed: bytes, sender: str
    ) -> None:
        """Gossip blob sidecar: verify (inclusion proof + KZG) into the DA
        checker; if this completes a block waiting on availability, import it
        (blob_verification.rs + data_availability_checker.rs)."""
        from ..chain.da import BlobError

        chain = self.chain
        try:
            sidecar = chain.types.BlobSidecar.from_ssz_bytes(uncompressed)
        except Exception:
            self.service.reject_gossip(sender, topic, "undecodable")
            return
        try:
            block_root = chain.da_checker.put_blob(sidecar)
        except BlobError as e:
            self.service.reject_gossip(
                sender, topic, "invalid_blob",
                action=PeerAction.MID_TOLERANCE, detail=str(e))
            return
        self.service.forward(topic, compressed, exclude=sender,
                             uncompressed=uncompressed)
        ready = chain.da_checker.take_ready_block(block_root)
        if ready is not None:
            try:
                chain.process_block(ready)
            except BlockError:
                pass  # unrelated import failure; peers already penalized upstream

    def _process_gossip_attestations(self, items: List[tuple]) -> None:
        """Batch-coalesced attestation verification (reference
        ``process_gossip_attestation_batch`` /
        ``attestation_verification/batch.rs:31-224``): every item in the
        drained batch is spec-checked and dedup'd individually, then ALL
        signature sets verify in ONE backend call — one padded device program
        per drained queue batch.  On batch failure, fall back to per-item
        verification so only the actually-bad items are penalized (the
        fidelity fallback, batch.rs:205)."""
        from ..crypto.bls import api as bls

        chain = self.chain
        candidates = []  # (candidate, topic, compressed, sender)
        for topic, uncompressed, compressed, sender in items:
            try:
                kind = topics_mod.GossipTopic.parse(topic).kind
                is_aggregate = kind == topics_mod.BEACON_AGGREGATE_AND_PROOF
                if is_aggregate:
                    agg = chain.types.SignedAggregateAndProof.from_ssz_bytes(uncompressed)
                    attestation = agg.message.aggregate
                else:
                    attestation = chain.types.Attestation.from_ssz_bytes(uncompressed)
            except Exception:
                self.service.reject_gossip(sender, topic, "undecodable")
                continue
            # Observed-cache dedup BEFORE any signature work (the gossip
            # replay/DoS defense; observed_attesters.rs semantics).
            target_epoch = int(attestation.data.target.epoch)
            if is_aggregate:
                att_root = attestation.hash_tree_root()
                if chain.observed.aggregates.is_known(int(attestation.data.slot), att_root):
                    continue  # exact duplicate aggregate
                if chain.observed.aggregators.is_known(
                    target_epoch, int(agg.message.aggregator_index)
                ):
                    continue  # aggregator already aggregated this epoch
            try:
                if is_aggregate:
                    # Full aggregate gossip verification: aggregator committee
                    # membership + is_aggregator + 3 signature sets (selection
                    # proof, outer sig, indexed att) — never just the inner
                    # aggregate.
                    cand = chain.preverify_aggregate(agg)
                    sig_sets = cand.signature_sets
                    inner = cand.inner
                else:
                    cand = chain.preverify_attestation(attestation)
                    sig_sets = [cand.signature_set]
                    inner = cand
            except AttestationError as e:
                if "unknown head block" in str(e):
                    # Pre-finalization roots can never become the head: reject
                    # and penalize (reference attestation_verification.rs ->
                    # is_pre_finalization_block).  Genuinely-unknown roots are
                    # left to sync's single-block lookup, unpenalized.
                    root = bytes(attestation.data.beacon_block_root)
                    if chain.is_pre_finalization_block(root):
                        self.service.reject_gossip(
                            sender, topic, "pre_finalization_attestation")
                    elif self.sync is not None:
                        # genuinely unknown: park the raw item until the
                        # root imports (park BEFORE the lookup spawns, or
                        # the import could land between the two and strand
                        # the attestation), then chase the block off-thread
                        # The re-queued event must carry the SAME batch
                        # shape as fresh gossip (item + process_batch): a
                        # released park coalesces with live attestation
                        # events in the processor's drain batch, and a
                        # shapeless event there feeds item=None into the
                        # batch handler — the unpack TypeError then kills
                        # the WHOLE drained batch in the worker-panic
                        # handler (silent attestation loss the 128-epoch
                        # soak caught as nondeterministic block content).
                        item = (topic, uncompressed, compressed, sender)
                        self.reprocess.await_block(root, WorkEvent(
                            work_type=W.GOSSIP_ATTESTATION,
                            process=lambda it:
                                self._process_gossip_attestations([it]),
                            process_batch=self._process_gossip_attestations,
                            item=item,
                        ))
                        if chain.fork_choice.contains_block(root):
                            # ANOTHER import path (range sync, a parent
                            # chase) landed the root between preverify and
                            # the park — its hook has already fired, so
                            # release the fresh park ourselves
                            self.reprocess.block_imported(root)
                        else:
                            self.sync.lookup_block_async(root, sender)
                    continue
                self.service.reject_gossip(
                    sender, topic, "invalid_attestation",
                    action=PeerAction.MID_TOLERANCE, detail=str(e))
                continue
            slasher_only = False
            if not is_aggregate:
                vidx = (
                    int(inner.indexed.attesting_indices[0])
                    if len(inner.indexed.attesting_indices) == 1
                    else None
                )
                if vidx is not None and chain.observed.attesters.is_known(
                    target_epoch, vidx
                ):
                    # Validator already attested this epoch: IGNORE for fork
                    # choice/forwarding — but a second message for the same
                    # epoch is exactly what a double/surround voter emits, so
                    # the slasher still gets it once the signature verifies
                    # (reference handle_attestation_verification_failure:
                    # PriorAttestationKnown still feeds the slasher).
                    if self.slasher is None:
                        continue
                    slasher_only = True
            candidates.append((cand, sig_sets, is_aggregate, topic, compressed,
                               sender, slasher_only))
        if not candidates:
            return

        # ONE verification group for the whole drained batch (aggregates
        # contribute 3 sets each — batch.rs:31-135 semantics).  Through the
        # async device pipeline this group coalesces with whatever block
        # import / sync-committee / other gossip workers submitted
        # concurrently — the worker waits on a future, not on the device.
        from .. import device_pipeline

        kind = ("gossip_aggregate" if any(c[2] for c in candidates)
                else "gossip_attestation")
        with device_pipeline.work_context(kind):
            batch_ok = bls.verify_signature_sets(
                [s for c in candidates for s in c[1]]
            )
        for (cand, sig_sets, is_aggregate, topic, compressed, sender,
             slasher_only) in candidates:
            ok = batch_ok or bls.verify_signature_sets(sig_sets)
            if not ok:
                self.service.reject_gossip(
                    sender, topic, "bad_signature",
                    action=PeerAction.MID_TOLERANCE)
                continue
            indexed = cand.inner.indexed if is_aggregate else cand.indexed
            # The slasher eats on SIGNATURE verification, before the
            # fork-choice apply (reference: slashing evidence needs a valid
            # signature, not a successful import) — an equivocating vote
            # whose apply fails (e.g. its target was pruned from our view)
            # is still evidence.
            if self.slasher is not None:
                self.slasher.on_attestation(indexed)
                self._drain_slasher()
            if slasher_only:
                # verified duplicate: slashing evidence only — no fork-choice
                # weight, no forward (the epoch's first message already won)
                continue
            try:
                if is_aggregate:
                    chain.apply_verified_aggregate(cand)
                else:
                    chain.apply_attestation(cand)
            except Exception as e:
                # One bad item (e.g. fork choice's validate_on_attestation
                # rejecting a crafted target) must never kill the rest of
                # the drained batch — the byzantine soak caught exactly
                # this: a half-bad batch silently dropped every later
                # candidate, slasher evidence included.  IGNORE, don't
                # penalize: a candidate that preverified and then fails
                # apply is usually a view-lag race (our fork choice pruned
                # the target between the two), and scoring honest relayers
                # for it bleeds the mesh.
                self.service.reject_gossip(
                    sender, topic, "apply_failed", detail=str(e),
                    penalize=False)
                continue
            self.service.forward(topic, compressed, exclude=sender)

    def _drain_slasher(self) -> None:
        """Slashings found by the slasher enter the op pool for our next
        proposal AND gossip out on the slashing topics (reference
        slasher_service: slashings are broadcast so ANY proposer can include
        them, not just us).  Both ride the chain's gossip-op path — dedup,
        signature verification, trial application, fork-choice equivocation
        mask — so a stale finding (validator already slashed) dies here
        instead of poisoning blocks."""
        attester, proposer = self.slasher.drain_slashings()
        for kind, ops, verify in (
            (topics_mod.ATTESTER_SLASHING, attester,
             self.chain.on_gossip_attester_slashing),
            (topics_mod.PROPOSER_SLASHING, proposer,
             self.chain.on_gossip_proposer_slashing),
        ):
            for s in ops:
                try:
                    fresh = verify(s)
                except ChainError:
                    metrics.SLASHER_SLASHINGS.inc(kind=kind, outcome="stale")
                    continue
                if not fresh:
                    metrics.SLASHER_SLASHINGS.inc(kind=kind, outcome="known")
                    continue
                metrics.SLASHER_SLASHINGS.inc(kind=kind, outcome="pooled")
                topic = topics_mod.GossipTopic(self.fork_digest, kind)
                self.service.publish(str(topic), s.as_ssz_bytes())

    # --------------------------------------------------------------- rpc

    def on_rpc_request(self, protocol: str, request, sender: str) -> List[bytes]:
        if protocol == rpc_mod.STATUS:
            self._handle_peer_status(sender, request)
            return [rpc_mod.encode_response_chunk(rpc_mod.SUCCESS, self.local_status().to_bytes())]
        if protocol == rpc_mod.PING:
            pong = rpc_mod.Ping(self.metadata.seq_number)
            return [rpc_mod.encode_response_chunk(rpc_mod.SUCCESS, pong.to_bytes())]
        if protocol == rpc_mod.METADATA:
            return [rpc_mod.encode_response_chunk(rpc_mod.SUCCESS, self.metadata.to_bytes())]
        if protocol == rpc_mod.GOODBYE:
            self.service.endpoint.disconnect(sender)
            return []
        if protocol == rpc_mod.BLOCKS_BY_RANGE:
            return self._serve_blocks_by_range(request, sender)
        if protocol == rpc_mod.BLOCKS_BY_ROOT:
            return self._serve_blocks_by_root(request, sender)
        if protocol == rpc_mod.BLOBS_BY_RANGE:
            return self._serve_blobs_by_range(request, sender)
        if protocol == rpc_mod.BLOBS_BY_ROOT:
            return self._serve_blobs_by_root(request, sender)
        if protocol == rpc_mod.LIGHT_CLIENT_BOOTSTRAP:
            bootstrap = self.chain.produce_light_client_bootstrap(
                bytes(request.root))
            if bootstrap is None:
                return [rpc_mod.encode_response_chunk(
                    rpc_mod.RESOURCE_UNAVAILABLE, b"")]
            return [self._lc_chunk(bootstrap, int(bootstrap.header.beacon.slot))]
        if protocol in (rpc_mod.LIGHT_CLIENT_OPTIMISTIC_UPDATE,
                        rpc_mod.LIGHT_CLIENT_FINALITY_UPDATE):
            update = (
                self.chain.lc_cache.latest_optimistic_update
                if protocol == rpc_mod.LIGHT_CLIENT_OPTIMISTIC_UPDATE
                else self.chain.lc_cache.latest_finality_update
            )
            if update is None:
                return [rpc_mod.encode_response_chunk(
                    rpc_mod.RESOURCE_UNAVAILABLE, b"")]
            return [self._lc_chunk(
                update, int(update.attested_header.beacon.slot))]
        if protocol == rpc_mod.PEER_EXCHANGE:
            return self._serve_peer_exchange(request, sender)
        return [rpc_mod.encode_response_chunk(rpc_mod.INVALID_REQUEST, b"unknown protocol")]

    def _blob_chunk(self, sidecar) -> bytes:
        slot = int(sidecar.signed_block_header.message.slot)
        epoch = slot // self.chain.spec.slots_per_epoch
        version = self.chain.spec.fork_version_for(self.chain.spec.fork_name_at_epoch(epoch))
        context = h.compute_fork_digest(
            version, bytes(self.chain.genesis_state.genesis_validators_root)
        )
        return rpc_mod.encode_response_chunk(
            rpc_mod.SUCCESS, sidecar.as_ssz_bytes(), context_bytes=context
        )

    def _serve_blobs_by_range(self, req, sender: str) -> List[bytes]:
        """Reference ``rpc_methods.rs`` handle_blobs_by_range_request:
        per-slot sidecars in ascending (slot, index) order."""
        if req.count > rpc_mod.MAX_REQUEST_BLOCKS:
            self.service.peer_manager.report(sender, PeerAction.LOW_TOLERANCE, "oversize range")
            return [rpc_mod.encode_response_chunk(rpc_mod.INVALID_REQUEST, b"count too large")]
        chain = self.chain
        chunks: List[bytes] = []
        prev_root = None
        for slot in range(req.start_slot, req.start_slot + req.count):
            root = chain.block_root_at_slot(slot) or chain.db.cold_block_root_at_slot(slot)
            if root is None or root == prev_root:
                continue
            prev_root = root
            for sidecar in sorted(chain.get_blobs(root), key=lambda s: int(s.index)):
                # a skip slot resolves to an EARLIER block; its sidecars are
                # outside the requested range and must not be served
                if int(sidecar.signed_block_header.message.slot) != slot:
                    continue
                chunks.append(self._blob_chunk(sidecar))
        return chunks

    def _serve_blobs_by_root(self, req, sender: str) -> List[bytes]:
        if len(req.ids) > rpc_mod.MAX_REQUEST_BLOCKS:
            return [rpc_mod.encode_response_chunk(rpc_mod.INVALID_REQUEST, b"too many ids")]
        chunks = []
        for root, index in req.ids:
            for sidecar in self.chain.get_blobs(root):
                if int(sidecar.index) == index:
                    chunks.append(self._blob_chunk(sidecar))
        return chunks

    def _serve_peer_exchange(self, req, sender: str) -> List[bytes]:
        """Share known listen addresses of our other peers (the discovery
        analog of a discv5 FINDNODE answer)."""
        return [rpc_mod.serve_peer_exchange(
            self.service.endpoint, sender, req.max_peers
        )]

    def _context_for_slot(self, slot: int) -> bytes:
        """Fork digest of the era ``slot`` belongs to — the context bytes
        every forked-payload chunk carries (container schemas differ per
        era; the startup digest would mislead post-transition clients)."""
        spec = self.chain.spec
        version = spec.fork_version_for(
            spec.fork_name_at_epoch(slot // spec.slots_per_epoch))
        return h.compute_fork_digest(
            version, bytes(self.chain.genesis_state.genesis_validators_root))

    def _lc_chunk(self, payload, slot: int) -> bytes:
        return rpc_mod.encode_response_chunk(
            rpc_mod.SUCCESS, payload.as_ssz_bytes(),
            context_bytes=self._context_for_slot(slot))

    def _block_chunk(self, signed_block) -> bytes:
        return rpc_mod.encode_response_chunk(
            rpc_mod.SUCCESS, signed_block.as_ssz_bytes(),
            context_bytes=self._context_for_slot(int(signed_block.message.slot)),
        )

    def _serve_blocks_by_range(self, req: rpc_mod.BlocksByRangeRequest, sender: str) -> List[bytes]:
        if req.count > rpc_mod.MAX_REQUEST_BLOCKS:
            self.service.peer_manager.report(sender, PeerAction.LOW_TOLERANCE, "oversize range")
            return [rpc_mod.encode_response_chunk(rpc_mod.INVALID_REQUEST, b"count too large")]
        chain = self.chain
        roots: List[bytes] = []
        slots: List[int] = []
        prev_root = None
        for slot in range(req.start_slot, req.start_slot + req.count):
            root = chain.block_root_at_slot(slot)
            if root is None or root == prev_root:
                root_cold = chain.db.cold_block_root_at_slot(slot)
                if root_cold is None or root_cold == prev_root:
                    continue
                root = root_cold
            prev_root = root
            roots.append(root)
            slots.append(slot)
        # Batched: blinded store hits cost one EL round trip total.
        chunks: List[bytes] = []
        for slot, block in zip(slots, chain.get_blocks(roots)):
            if block is not None and int(block.message.slot) == slot:
                chunks.append(self._block_chunk(block))
        return chunks

    def _serve_blocks_by_root(self, req: rpc_mod.BlocksByRootRequest, sender: str) -> List[bytes]:
        if len(req.roots) > rpc_mod.MAX_REQUEST_BLOCKS:
            return [rpc_mod.encode_response_chunk(rpc_mod.INVALID_REQUEST, b"too many roots")]
        chunks = []
        for block in self.chain.get_blocks(list(req.roots)):
            if block is not None:
                chunks.append(self._block_chunk(block))
        return chunks
