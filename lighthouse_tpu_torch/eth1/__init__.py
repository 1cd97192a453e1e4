"""Eth1 deposit-contract follower: deposit cache, eth1-data voting, and
deposit-triggered genesis.

Equivalent of the reference's ``beacon_node/eth1`` crate
(`src/service.rs` — polls the EL for deposit logs and eth1 block info into a
``deposit_cache``/``block_cache``) plus the deposit-triggered
``Eth1GenesisService`` (`beacon_node/genesis/src/lib.rs:1-12`).  Still needed
post-merge: block production must carry valid ``Deposit`` objects with
Merkle proofs whenever ``state.eth1_data.deposit_count`` runs ahead of
``state.eth1_deposit_index``.

The provider seam is any object with

    eth1_blocks() -> [ {number, hash, timestamp, deposit_count, deposit_root} ]
    deposit_logs(start_index, end_index) -> [DepositData-like]

— the engine-API/JSON-RPC implementation on a real EL, an in-process mock in
tests (the reference's pattern with ``MockServer``).

A copy of the JAX package's ``lighthouse_tpu/eth1/__init__.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..consensus import helpers as h
from ..types import ssz as ssz_mod

DEPOSIT_CONTRACT_TREE_DEPTH = 32


class Eth1Error(Exception):
    pass


class DepositCache:
    """Ordered deposit log + incremental Merkle proofs (reference
    ``eth1/src/deposit_cache.rs``): serves ``Deposit`` objects provable
    against any historical ``(deposit_root, deposit_count)`` pair."""

    def __init__(self, types):
        self.types = types
        self._deposit_data: List[object] = []  # DepositData in log order
        self._leaves: List[bytes] = []  # hash_tree_root(DepositData)

    def __len__(self) -> int:
        return len(self._deposit_data)

    def insert_log(self, index: int, deposit_data) -> None:
        if index != len(self._deposit_data):
            if index < len(self._deposit_data):
                return  # replayed log
            raise Eth1Error(
                f"non-contiguous deposit log {index} (have {len(self._deposit_data)})"
            )
        self._deposit_data.append(deposit_data)
        self._leaves.append(deposit_data.hash_tree_root())

    def deposit_root(self, count: Optional[int] = None) -> bytes:
        count = len(self._leaves) if count is None else count
        body = ssz_mod.merkleize(
            self._leaves[:count], 1 << DEPOSIT_CONTRACT_TREE_DEPTH
        )
        return ssz_mod.mix_in_length(body, count)

    def get_deposits(self, start: int, end: int, deposit_count: int) -> List[object]:
        """``Deposit``s for indices [start, end) with proofs against the tree
        at ``deposit_count`` (the eth1_data the state has voted in)."""
        if end > deposit_count or deposit_count > len(self._leaves):
            raise Eth1Error("requested deposits beyond the known tree")
        out = []
        chunks = self._leaves[:deposit_count]
        count_leaf = deposit_count.to_bytes(32, "little")
        for i in range(start, end):
            branch = ssz_mod.merkle_branch(
                chunks, 1 << DEPOSIT_CONTRACT_TREE_DEPTH, i
            )
            out.append(self.types.Deposit(
                proof=branch + [count_leaf],
                data=self._deposit_data[i],
            ))
        return out


class Eth1Service:
    """Follower + voting (reference ``eth1/src/service.rs`` + the
    ``eth1_chain.rs`` voting logic): polls the provider into the caches and
    answers 'what eth1_data should my block vote for' / 'which deposits must
    my block include'."""

    def __init__(self, *, provider, types, spec):
        self.provider = provider
        self.types = types
        self.spec = spec
        self.deposit_cache = DepositCache(types)
        self.block_cache: List[dict] = []  # ascending by number

    # ------------------------------------------------------------- polling

    def update(self) -> None:
        """One poll round: pull new eth1 blocks + deposit logs."""
        blocks = self.provider.eth1_blocks()
        self.block_cache = sorted(blocks, key=lambda b: b["number"])
        have = len(self.deposit_cache)
        want = max((b["deposit_count"] for b in self.block_cache), default=0)
        if want > have:
            for i, data in enumerate(self.provider.deposit_logs(have, want)):
                self.deposit_cache.insert_log(have + i, data)

    # -------------------------------------------------------------- voting

    def eth1_vote(self, state) -> object:
        """Spec ``get_eth1_vote``: prefer the majority vote among this
        period's ballots when it matches a known candidate block in the
        [eth1_follow_distance*2, eth1_follow_distance] window; otherwise the
        newest in-window candidate; otherwise keep the current eth1_data."""
        spec = self.spec
        period_start = self._voting_period_start_time(state)
        candidates = [
            b for b in self.block_cache
            if (b["timestamp"] + spec.seconds_per_eth1_block * spec.eth1_follow_distance
                <= period_start)
            and (b["timestamp"] + spec.seconds_per_eth1_block * spec.eth1_follow_distance * 2
                 >= period_start)
            and b["deposit_count"] >= int(state.eth1_data.deposit_count)
        ]
        valid = {
            (bytes(b["deposit_root"]), b["deposit_count"], bytes(b["hash"]))
            for b in candidates
        }
        tally: Dict[Tuple[bytes, int, bytes], int] = {}
        for vote in state.eth1_data_votes:
            key = (bytes(vote.deposit_root), int(vote.deposit_count), bytes(vote.block_hash))
            if key in valid:
                tally[key] = tally.get(key, 0) + 1
        if tally:
            key = max(tally, key=lambda k: (tally[k], k))
            return self.types.Eth1Data(
                deposit_root=key[0], deposit_count=key[1], block_hash=key[2]
            )
        if candidates:
            b = candidates[-1]
            return self.types.Eth1Data(
                deposit_root=bytes(b["deposit_root"]),
                deposit_count=b["deposit_count"],
                block_hash=bytes(b["hash"]),
            )
        return state.eth1_data.copy()

    def _voting_period_start_time(self, state) -> int:
        spec = self.spec
        slots_per_period = (
            spec.preset.epochs_per_eth1_voting_period * spec.slots_per_epoch
        )
        period_start_slot = int(state.slot) - int(state.slot) % slots_per_period
        return int(state.genesis_time) + period_start_slot * spec.seconds_per_slot

    # ------------------------------------------------------------ deposits

    def deposits_for_block(self, state, eth1_data=None) -> List[object]:
        """The deposits the next block MUST include (spec: min(MAX_DEPOSITS,
        eth1_data.deposit_count - eth1_deposit_index)).  ``eth1_data``
        overrides the state's when this block's own vote will flip it
        (process_eth1_data runs before process_operations)."""
        eth1_data = state.eth1_data if eth1_data is None else eth1_data
        start = int(state.eth1_deposit_index)
        count = int(eth1_data.deposit_count)
        if count <= start:
            return []
        end = min(count, start + self.spec.preset.max_deposits)
        if count > len(self.deposit_cache):
            return []  # logs not synced that far yet — cannot build proofs
        return self.deposit_cache.get_deposits(start, end, count)


class Eth1GenesisService:
    """Deposit-triggered genesis (reference ``genesis/src/lib.rs``): watch
    the provider until MIN_GENESIS_ACTIVE_VALIDATOR_COUNT valid deposits
    exist at/after MIN_GENESIS_TIME, then build the genesis state."""

    def __init__(self, *, provider, types, spec):
        self.service = Eth1Service(provider=provider, types=types, spec=spec)
        self.types = types
        self.spec = spec

    def try_genesis(self):
        """One attempt; returns the genesis state or None if not ready."""
        from ..consensus.genesis import initialize_beacon_state_from_eth1

        self.service.update()
        spec = self.spec
        for block in self.service.block_cache:
            # spec condition is on state.genesis_time (= eth1 timestamp +
            # GENESIS_DELAY), not the raw eth1 timestamp
            if block["timestamp"] + spec.genesis_delay < getattr(spec, "min_genesis_time", 0):
                continue
            count = block["deposit_count"]
            if count < spec.min_genesis_active_validator_count:
                continue
            if count > len(self.service.deposit_cache):
                continue
            # Genesis verifies deposit i against the INCREMENTAL tree root
            # over deposits[:i+1] (spec initialize_beacon_state_from_eth1),
            # so each proof is built at its own count.
            deposits = [
                self.service.deposit_cache.get_deposits(i, i + 1, i + 1)[0]
                for i in range(count)
            ]
            state = initialize_beacon_state_from_eth1(
                bytes(block["hash"]), block["timestamp"], deposits,
                self.types, spec,
            )
            active = len(h.get_active_validator_indices(state, 0))
            if active >= spec.min_genesis_active_validator_count:
                # spec is_valid_genesis_state counts ACTIVE validators — an
                # underfunded deposit creates a record but not an activation
                return state
        return None
