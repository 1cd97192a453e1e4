"""Light client: the verifying consumer of the LC server's objects.

The altair sync-protocol state machine (spec ``sync-protocol.md``; the
reference ships the types + server while Siren/helios consume them — here the
consumer lives in-repo so the served objects are verified end-to-end):

- ``LightClientStore.bootstrap`` checks the current-sync-committee branch
  against a TRUSTED block root.
- ``process_update`` verifies the sync aggregate (2/3 supermajority of the
  known committee over the attested header), the finality branch, and the
  next-sync-committee branch, then advances finalized/optimistic heads and
  rotates committees across periods.

A copy of the JAX package's ``lighthouse_tpu/light_client/__init__.py``.
The sync aggregate verifies through the port's ``crypto.bls.api``, so on a
node's default backend (``"torch"`` on the card) it is a batch on the card.
"""

from __future__ import annotations

from typing import Optional

from ..consensus import helpers as h
from ..consensus.signature_sets import pubkey_cache
from ..crypto.bls import api as bls
from ..types.spec import DOMAIN_SYNC_COMMITTEE, ChainSpec
from ..consensus.per_block import is_valid_merkle_branch

CURRENT_SYNC_COMMITTEE_INDEX = 22  # state field indices (all forks)
NEXT_SYNC_COMMITTEE_INDEX = 23
FINALIZED_ROOT_SUBINDEX = 20 * 2 + 1  # checkpoint.root under finalized_checkpoint
# depths derive from the received branch lengths: 5/6 through deneb,
# 6/7 for electra's 64-leaf state layout
EXECUTION_PAYLOAD_SUBINDEX = 9  # body field index (gindex 25, depth 4)


class LightClientError(Exception):
    pass


def is_valid_light_client_header(header, spec=None) -> bool:
    """Spec ``is_valid_light_client_header`` for capella+ headers: the
    execution payload header's root must prove against the beacon header's
    body root through the 4-deep ``execution_branch`` (gindex 25 — reference
    light_client_header.rs:52-59).  Altair-era (beacon-only) headers are
    trivially valid — and so is a capella+ CONTAINER carrying a pre-capella
    BLOCK, which the spec requires to hold the default (all-zero) execution
    header and branch (e.g. the finalized header of an update spanning the
    capella fork epoch)."""
    if "execution" not in header.fields:
        return True
    branch_is_zero = all(bytes(b) == b"\x00" * 32 for b in header.execution_branch)
    if branch_is_zero:
        pre_capella = spec is not None and spec.fork_name_at_slot(
            int(header.beacon.slot)
        ) not in ("capella", "deneb", "electra")
        exec_is_default = (
            header.execution.hash_tree_root()
            == type(header.execution)().hash_tree_root()
        )
        if pre_capella or spec is None:
            return exec_is_default
        return False
    return is_valid_merkle_branch(
        header.execution.hash_tree_root(),
        header.execution_branch,
        len(header.execution_branch),
        EXECUTION_PAYLOAD_SUBINDEX,
        bytes(header.beacon.body_root),
    )


def _require_valid_header(header, what: str, spec=None) -> None:
    if not is_valid_light_client_header(header, spec):
        raise LightClientError(f"invalid execution branch in {what} header")


class LightClientStore:
    """Minimal spec LC store: finalized + optimistic headers, current/next
    sync committees, period rotation."""

    def __init__(self, types, spec: ChainSpec,
                 genesis_validators_root: bytes):
        self.types = types
        self.spec = spec
        self.genesis_validators_root = bytes(genesis_validators_root)
        self.finalized_header = None
        self.optimistic_header = None
        self.current_sync_committee = None
        self.next_sync_committee = None
        self.committee_period = 0

    # ----------------------------------------------------------- bootstrap

    def bootstrap(self, trusted_block_root: bytes, bootstrap) -> None:
        header_root = bootstrap.header.beacon.hash_tree_root()
        if header_root != bytes(trusted_block_root):
            raise LightClientError("bootstrap header does not match trusted root")
        _require_valid_header(bootstrap.header, "bootstrap", self.spec)
        if not is_valid_merkle_branch(
            bootstrap.current_sync_committee.hash_tree_root(),
            bootstrap.current_sync_committee_branch,
            len(bootstrap.current_sync_committee_branch),
            CURRENT_SYNC_COMMITTEE_INDEX,
            bytes(bootstrap.header.beacon.state_root),
        ):
            raise LightClientError("invalid current-sync-committee branch")
        self.finalized_header = bootstrap.header.copy()
        self.optimistic_header = bootstrap.header.copy()
        self.current_sync_committee = bootstrap.current_sync_committee.copy()
        self.committee_period = self._period(int(bootstrap.header.beacon.slot))

    # -------------------------------------------------------------- updates

    def _period(self, slot: int) -> int:
        return (int(slot) // self.spec.slots_per_epoch) \
            // self.spec.preset.epochs_per_sync_committee_period

    def _verify_sync_aggregate(self, attested_header, sync_aggregate,
                               signature_slot: int) -> int:
        """Verify; returns the signature period (for committee rotation)."""
        bits = list(sync_aggregate.sync_committee_bits)
        if sum(bits) * 3 < len(bits) * 2:
            raise LightClientError("insufficient sync committee participation")
        sig_period = self._period(max(int(signature_slot), 1) - 1)
        if self.current_sync_committee is None:
            raise LightClientError("store not bootstrapped")
        if sig_period == self.committee_period:
            committee = self.current_sync_committee
        elif sig_period == self.committee_period + 1 and self.next_sync_committee is not None:
            committee = self.next_sync_committee
        else:
            raise LightClientError(
                f"update period {sig_period} not applicable "
                f"(store at {self.committee_period})"
            )
        participants = [
            pubkey_cache(bytes(committee.pubkeys[i]))
            for i, bit in enumerate(bits) if bit
        ]
        prev_slot = max(int(signature_slot), 1) - 1
        epoch = prev_slot // self.spec.slots_per_epoch
        fork_version = self.spec.fork_version_for(self.spec.fork_name_at_epoch(epoch))
        domain = h.compute_domain(
            DOMAIN_SYNC_COMMITTEE, fork_version, self.genesis_validators_root
        )
        signing_root = h.compute_signing_root(
            attested_header.beacon.hash_tree_root(), domain
        )
        sig_set = bls.SignatureSet(
            bls.Signature.from_bytes(bytes(sync_aggregate.sync_committee_signature)),
            signing_root, participants,
        )
        if not bls.verify_signature_sets([sig_set]):
            raise LightClientError("invalid sync aggregate signature")
        return sig_period

    def process_update(self, update) -> None:
        """Full ``LightClientUpdate``: rotates the committee period and, when
        the update carries finality (non-zero branch), advances the
        finalized head."""
        sig_period = self._verify_sync_aggregate(
            update.attested_header, update.sync_aggregate, int(update.signature_slot)
        )
        _require_valid_header(update.attested_header, "attested", self.spec)
        has_finality = any(any(b) for b in update.finality_branch)
        if has_finality:
            _require_valid_header(update.finalized_header, "finalized", self.spec)
        fin_depth = len(update.finality_branch)
        if has_finality and not is_valid_merkle_branch(
            bytes(update.finalized_header.beacon.hash_tree_root()),
            update.finality_branch,
            fin_depth,
            FINALIZED_ROOT_SUBINDEX,  # 2*20+1 in every era (leaf position
                                      # is depth-independent)
            bytes(update.attested_header.beacon.state_root),
        ):
            raise LightClientError("invalid finality branch")
        if not is_valid_merkle_branch(
            update.next_sync_committee.hash_tree_root(),
            update.next_sync_committee_branch,
            len(update.next_sync_committee_branch),
            NEXT_SYNC_COMMITTEE_INDEX,
            bytes(update.attested_header.beacon.state_root),
        ):
            raise LightClientError("invalid next-sync-committee branch")

        # Committee rotation keyed on the verified SIGNATURE period: an
        # update signed by the NEXT committee proves that period is live.
        if sig_period == self.committee_period + 1:
            self.current_sync_committee = self.next_sync_committee
            self.next_sync_committee = None
            self.committee_period += 1
        attested_period = self._period(int(update.attested_header.beacon.slot))
        if attested_period == self.committee_period and self.next_sync_committee is None:
            self.next_sync_committee = update.next_sync_committee.copy()

        if has_finality and int(update.finalized_header.beacon.slot) > int(
            self.finalized_header.beacon.slot
        ):
            self.finalized_header = update.finalized_header.copy()
        if int(update.attested_header.beacon.slot) > int(self.optimistic_header.beacon.slot):
            self.optimistic_header = update.attested_header.copy()

    def process_finality_update(self, update) -> None:
        self._verify_sync_aggregate(
            update.attested_header, update.sync_aggregate, int(update.signature_slot)
        )
        _require_valid_header(update.attested_header, "attested", self.spec)
        _require_valid_header(update.finalized_header, "finalized", self.spec)
        fin_depth = len(update.finality_branch)
        if not is_valid_merkle_branch(
            bytes(update.finalized_header.beacon.hash_tree_root()),
            update.finality_branch,
            fin_depth,
            FINALIZED_ROOT_SUBINDEX,  # 2*20+1 in every era (leaf position
                                      # is depth-independent)
            bytes(update.attested_header.beacon.state_root),
        ):
            raise LightClientError("invalid finality branch")
        if int(update.finalized_header.beacon.slot) > int(self.finalized_header.beacon.slot):
            self.finalized_header = update.finalized_header.copy()
        if int(update.attested_header.beacon.slot) > int(self.optimistic_header.beacon.slot):
            self.optimistic_header = update.attested_header.copy()

    def process_optimistic_update(self, update) -> None:
        self._verify_sync_aggregate(
            update.attested_header, update.sync_aggregate, int(update.signature_slot)
        )
        _require_valid_header(update.attested_header, "attested", self.spec)
        if int(update.attested_header.beacon.slot) > int(self.optimistic_header.beacon.slot):
            self.optimistic_header = update.attested_header.copy()


class RpcLightClient:
    """A verifying light client that syncs OVER THE WIRE: bootstrap and
    updates arrive through the spec light-client req/resp protocols
    (reference: the LC server protocols in rpc/protocol.rs consumed by
    light-client processes) instead of a local chain handle."""

    def __init__(self, *, service, peer: str, types, spec,
                 genesis_validators_root: bytes):
        self.service = service
        self.peer = peer
        self.types = types
        self.spec = spec
        self.store = LightClientStore(types, spec, genesis_validators_root)

    def _request(self, protocol, request):
        """Returns (ssz_payload, era_name): the chunk's context bytes name
        the payload's fork era — LC container schemas differ per era, so
        decoding with a fixed-era type would misparse post-fork payloads."""
        from ..network import rpc as rpc_mod
        from ..network.topics import fork_name_for_digest

        chunks = self.service.request(self.peer, protocol, request, timeout=10.0)
        if not chunks or chunks[0][0] != rpc_mod.SUCCESS:
            raise LightClientError(
                f"peer {self.peer} could not serve {protocol}")
        _result, payload, context = chunks[0]
        era = None
        if context:
            era = fork_name_for_digest(
                context, bytes(self.store.genesis_validators_root), self.spec)
        if era is None:
            raise LightClientError(
                f"peer {self.peer} sent an unknown fork context for {protocol}")
        return payload, era

    def sync_from_peer(self, trusted_block_root: bytes) -> None:
        """Bootstrap from a trusted root, then apply the peer's latest
        optimistic update — all fetched and VERIFIED over RPC.  The update
        half is best-effort: a peer with no update yet, a transport
        hiccup, or an update from a not-yet-applicable sync period leaves
        the verified bootstrapped state standing."""
        from ..network import rpc as rpc_mod

        raw, era = self._request(
            rpc_mod.LIGHT_CLIENT_BOOTSTRAP,
            rpc_mod.LightClientBootstrapRequest(root=trusted_block_root),
        )
        lc = self.types.light_client[era]
        self.store.bootstrap(trusted_block_root, lc["bootstrap"].from_ssz_bytes(raw))
        try:
            raw, era = self._request(
                rpc_mod.LIGHT_CLIENT_OPTIMISTIC_UPDATE, None)
            lc = self.types.light_client[era]
            self.store.process_optimistic_update(
                lc["optimistic_update"].from_ssz_bytes(raw))
        except (LightClientError, rpc_mod.RpcError):
            return  # optional follow-up: bootstrapped state stands
