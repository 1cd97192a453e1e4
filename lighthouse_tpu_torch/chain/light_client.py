"""Light-client server: bootstrap / update / finality-update / optimistic-
update production from import-time caching.

Equivalent of the reference's ``beacon_chain/src/light_client_server_cache.rs``
(+ the LC types in ``consensus/types/src/light_client_*.rs``): every imported
block whose sync aggregate has participants yields

- an **optimistic update** (attested header = the parent the committee
  signed, best-participation-wins per slot),
- a **finality update** (plus the attested state's finalized header and its
  Merkle branch), and
- a per-sync-committee-period **best update** carrying the next sync
  committee and its branch (the altair sync-protocol object light clients
  replay period by period).

Bootstraps are built on demand from any stored finalized block/state.

Branch depths follow the state's field count: ≤32 fields (altair..deneb) is
a depth-5 tree with the finalized root one level deeper; electra's 37-field
state is depth 6/7 and is served with the electra LC container variants
(the fork-era registry ``types.light_client``).

A copy of the JAX package's ``lighthouse_tpu/chain/light_client.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..types import ssz as ssz_mod

SYNC_COMMITTEE_BRANCH_DEPTH = 5
FINALITY_BRANCH_DEPTH = 6


def state_depth(state) -> int:
    """Merkle depth of the state container's field tree (5 through deneb,
    6 for electra's 37 fields)."""
    return max(0, (len(state.ssz_type.field_types) - 1).bit_length())


def era_for_slot(spec, slot: int) -> str:
    """LC container era for objects at ``slot``: tracks the header format
    (capella introduces the execution header, light_client_header.rs:40-59)
    and the electra branch deepening.  altair/bellatrix share the
    beacon-only header."""
    fork = spec.fork_name_at_slot(int(slot))
    if fork in ("capella", "deneb", "electra"):
        return fork
    return "altair"


def lc_era(state, spec=None) -> str:
    """Which LC container era a state's objects must use."""
    if spec is not None:
        return era_for_slot(spec, int(state.slot))
    # Fallback (legacy callers): depth-only discrimination.
    return "electra" if state_depth(state) > SYNC_COMMITTEE_BRANCH_DEPTH else "altair"


def state_field_roots(state) -> List[bytes]:
    """Per-field hash roots of a state container (the leaves the LC branches
    prove against) — served by the incremental tree-hash cache when the
    state carries one (every hashed state does), so building branches costs
    O(cached) instead of a full re-merkleization."""
    cache = getattr(state, "_thc", None)
    if cache is not None:
        return cache.field_roots(state)
    t = state.ssz_type
    return [ft.hash_tree_root(getattr(state, name)) for name, ft in t.field_types.items()]


def _field_branch(state, field_name: str, roots: Optional[List[bytes]] = None):
    t = state.ssz_type
    names = list(t.field_types)
    if field_name not in t.field_types:
        return None  # pre-altair state: no sync committees
    depth = state_depth(state)
    if roots is None:
        roots = state_field_roots(state)
    return ssz_mod.merkle_branch(roots, 1 << depth, names.index(field_name))


def sync_committee_branch(state, field_name: str,
                          roots: Optional[List[bytes]] = None):
    return _field_branch(state, field_name, roots)


def finality_branch(state, roots: Optional[List[bytes]] = None):
    """Branch proving ``finalized_checkpoint.root`` under the state root:
    the checkpoint's own epoch-sibling leaf + the state-level branch."""
    t = state.ssz_type
    names = list(t.field_types)
    cp = state.finalized_checkpoint
    epoch_leaf = ssz_mod.uint64.hash_tree_root(int(cp.epoch))
    if roots is None:
        roots = state_field_roots(state)
    state_level = ssz_mod.merkle_branch(
        roots, 1 << state_depth(state), names.index("finalized_checkpoint")
    )
    # Checkpoint = (epoch, root): root is leaf index 1, sibling = epoch leaf.
    return [epoch_leaf] + state_level


def _payload_to_lc_exec_header(types, payload, era: str):
    """Payload -> the ERA's execution payload header, zero-extending fields
    the payload's own fork predates (the spec's upgrade_lc_header_to_*
    functions default new fields — e.g. a capella finalized block inside a
    deneb update gets blob_gas_used = excess_blob_gas = 0)."""
    hdr_cls = types.payload_header["deneb" if era == "electra" else era]
    kwargs = {}
    for name in hdr_cls.fields:
        if name == "transactions_root":
            kwargs[name] = payload.fields["transactions"].hash_tree_root(
                payload.transactions)
        elif name == "withdrawals_root":
            kwargs[name] = payload.fields["withdrawals"].hash_tree_root(
                payload.withdrawals)
        elif hasattr(payload, name):
            kwargs[name] = getattr(payload, name)
    return hdr_cls(**kwargs)


def block_to_lc_header(types, block_or_header, spec=None, era: str = None):
    """Per-era LC header for a block (light_client_header.rs:40-59).

    ``era`` is the CONTAINER era (defaults to the block slot's own era; an
    update spanning a fork boundary passes its attested era so both headers
    share one container type).  The execution part is present iff the block
    itself is capella+ (spec ``block_to_light_client_header``): the payload
    header plus the 4-deep Merkle branch proving it under the body root —
    built from one body field-root pass (which also yields the body root,
    so the beacon header costs nothing extra).  A bare ``BeaconBlockHeader``
    input (no body available — the genesis-anchor corner) degrades to a
    zeroed execution header."""
    msg = getattr(block_or_header, "message", block_or_header)
    if era is None:
        era = (era_for_slot(spec, int(msg.slot))
               if spec is not None else "altair")
    hdr_cls = types.light_client[era]["header"]

    if hasattr(msg, "body_root"):  # bare header: no body to prove against
        return hdr_cls(beacon=msg.copy())

    body = msg.body
    bt = body.ssz_type
    froots = [ft.hash_tree_root(getattr(body, n))
              for n, ft in bt.field_types.items()]
    beacon = types.BeaconBlockHeader(
        slot=msg.slot,
        proposer_index=msg.proposer_index,
        parent_root=msg.parent_root,
        state_root=msg.state_root,
        body_root=ssz_mod.merkleize(froots),
    )
    block_fork = spec.fork_name_at_slot(int(msg.slot)) if spec is not None else None
    if (era == "altair"
            or block_fork not in ("capella", "deneb", "electra")
            or not hasattr(body, "execution_payload")):
        # Pre-capella block (or altair-era container): beacon-only /
        # zeroed execution per the spec's default header.
        return hdr_cls(beacon=beacon)

    names = list(bt.field_types)
    idx = names.index("execution_payload")
    return hdr_cls(
        beacon=beacon,
        execution=_payload_to_lc_exec_header(types, body.execution_payload, era),
        execution_branch=ssz_mod.merkle_branch(froots, 16, idx),
    )


class LightClientServerCache:
    """Import-time LC object production (reference
    ``light_client_server_cache.rs``)."""

    def __init__(self, types, spec):
        self.types = types
        self.spec = spec
        self.latest_finality_update = None
        self.latest_optimistic_update = None
        # sync-committee period -> best LightClientUpdate
        self.best_updates: Dict[int, object] = {}
        self._new_finality = None  # gossip-publish queue (router drains)
        self._new_optimistic = None

    def _period(self, slot: int) -> int:
        return (slot // self.spec.slots_per_epoch) // self.spec.preset.epochs_per_sync_committee_period

    def on_block_imported(self, *, block, parent_block, parent_state,
                          finalized_block) -> None:
        """Called after import: ``block`` carries a sync aggregate signing
        ``parent_block`` (header) as attested, over ``parent_state`` (the
        attested state the branches come from).  ``finalized_block`` is the
        block at ``parent_state.finalized_checkpoint.root`` (may be None
        early in the chain)."""
        sync_aggregate = getattr(block.message.body, "sync_aggregate", None)
        if sync_aggregate is None or not any(sync_aggregate.sync_committee_bits):
            return
        if not hasattr(parent_state, "current_sync_committee"):
            return
        participation = sum(sync_aggregate.sync_committee_bits)
        signature_slot = int(block.message.slot)
        era = lc_era(parent_state, self.spec)
        lc = self.types.light_client[era]
        attested_header = block_to_lc_header(
            self.types, parent_block, self.spec, era=era)
        # One field-root pass serves both branches below (the cache makes it
        # incremental; recomputing per branch would double the cost).
        roots = state_field_roots(parent_state)

        optimistic = lc["optimistic_update"](
            attested_header=attested_header,
            sync_aggregate=sync_aggregate.copy(),
            signature_slot=signature_slot,
        )
        cur = self.latest_optimistic_update
        if cur is None or int(cur.signature_slot) < signature_slot or (
            int(cur.signature_slot) == signature_slot
            and sum(cur.sync_aggregate.sync_committee_bits) < participation
        ):
            self.latest_optimistic_update = optimistic
            self._new_optimistic = optimistic

        fin_branch = finality_branch(parent_state, roots)
        finalized_header = (
            block_to_lc_header(self.types, finalized_block, self.spec, era=era)
            if fin_branch is not None and finalized_block is not None else None
        )
        if finalized_header is not None:
            finality = lc["finality_update"](
                attested_header=attested_header,
                finalized_header=finalized_header,
                finality_branch=fin_branch,
                sync_aggregate=sync_aggregate.copy(),
                signature_slot=signature_slot,
            )
            curf = self.latest_finality_update
            if curf is None or int(curf.signature_slot) < signature_slot or (
                int(curf.signature_slot) == signature_slot
                and sum(curf.sync_aggregate.sync_committee_bits) < participation
            ):
                self.latest_finality_update = finality
                self._new_finality = finality

        # Period update: carries next_sync_committee (proven on the attested
        # state) so clients can advance committee periods.  Finality is
        # OPTIONAL (spec: zeroed finalized header/branch when the chain
        # hasn't finalized within reach yet) — without this, the periods
        # before first finality would have no updates and light clients
        # could never rotate past them.
        nsc_branch = sync_committee_branch(parent_state, "next_sync_committee", roots)
        if nsc_branch is not None:
            if finalized_header is not None:
                fin_header = finalized_header
                fin_br = fin_branch
                has_finality = True
            else:
                fin_header = lc["header"]()
                fin_br = [b"\x00" * 32] * (state_depth(parent_state) + 1)
                has_finality = False
            period = self._period(int(parent_block.message.slot)
                                  if hasattr(parent_block, "message")
                                  else int(parent_block.slot))
            update = lc["update"](
                attested_header=attested_header,
                next_sync_committee=parent_state.next_sync_committee.copy(),
                next_sync_committee_branch=nsc_branch,
                finalized_header=fin_header,
                finality_branch=fin_br,
                sync_aggregate=sync_aggregate.copy(),
                signature_slot=signature_slot,
            )
            best = self.best_updates.get(period)
            # Finality-carrying updates outrank finality-less ones; then
            # higher participation wins (the reference's is_better_update).
            def rank(u):
                return (any(any(b) for b in u.finality_branch),
                        sum(u.sync_aggregate.sync_committee_bits))

            if best is None or rank(best) < rank(update):
                self.best_updates[period] = update

    def produce_bootstrap(self, state, block):
        """``LightClientBootstrap`` for a finalized block/state pair; None
        for pre-altair states (no sync committees to prove)."""
        if not hasattr(state, "current_sync_committee"):
            return None
        branch = sync_committee_branch(state, "current_sync_committee")
        if branch is None:
            return None
        era = lc_era(state, self.spec)
        return self.types.light_client[era]["bootstrap"](
            header=block_to_lc_header(self.types, block, self.spec),
            current_sync_committee=state.current_sync_committee.copy(),
            current_sync_committee_branch=branch,
        )

    def get_updates(self, start_period: int, count: int) -> List[object]:
        out = []
        for p in range(start_period, start_period + min(count, 128)):
            u = self.best_updates.get(p)
            if u is not None:
                out.append(u)
        return out

    def take_new_updates(self) -> Tuple[Optional[object], Optional[object]]:
        """(finality_update, optimistic_update) produced since the last call
        — the router publishes these on the LC gossip topics."""
        f, o = self._new_finality, self._new_optimistic
        self._new_finality = self._new_optimistic = None
        return f, o

    def prune(self, current_period: int, keep_periods: int = 128) -> None:
        for p in [p for p in self.best_updates if p + keep_periods < current_period]:
            del self.best_updates[p]
