"""Blinded-block payload reconstruction (beacon block streamer).

Equivalent of the reference's
``beacon_node/beacon_chain/src/beacon_block_streamer.rs`` (1,008 LoC): the
store may hold POST-MERGE blocks in blinded form (execution payload replaced
by its header — how the reference persists every block); anything that must
serve a FULL block (``/eth/v2/beacon/blocks/{id}``, BlocksByRange/Root RPC)
reconstructs the payload from the execution layer via
``engine_getPayloadBodiesByHash`` (batched — one EL round trip per request,
not per block), rebuilds the block, and verifies the rebuilt payload
summarizes to the stored header before handing it out.

Pre-merge blocks (no payload) pass through untouched.

A copy of the JAX package's ``lighthouse_tpu/chain/block_streamer.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..consensus.per_block import execution_payload_to_header


class ReconstructionError(Exception):
    pass


def is_blinded(signed_block) -> bool:
    return hasattr(signed_block.message.body, "execution_payload_header")


def blind_signed_block(signed_block, types):
    """Full -> blinded: replace the execution payload with its header
    (inverse of the rebuild loop of the JAX package's
    ``BeaconChain.unblind_and_import``)."""
    block = signed_block.message
    fork = type(block).fork_name
    body_kwargs = {}
    for name in block.body.fields:
        if name == "execution_payload":
            body_kwargs["execution_payload_header"] = execution_payload_to_header(
                block.body.execution_payload, types, fork
            )
        else:
            body_kwargs[name] = getattr(block.body, name)
    blinded = types.blinded_block[fork](
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=block.state_root,
        body=types.blinded_block_body[fork](**body_kwargs),
    )
    return types.signed_blinded_block[fork](
        message=blinded, signature=signed_block.signature
    )


class BeaconBlockStreamer:
    """Batched full-block reconstruction over the chain's execution engine."""

    def __init__(self, chain) -> None:
        self.chain = chain

    # ------------------------------------------------------------ plumbing

    def _payload_cls(self, fork: str):
        types = self.chain.types
        return {
            "bellatrix": types.ExecutionPayloadBellatrix,
            "capella": types.ExecutionPayloadCapella,
            "deneb": types.ExecutionPayloadDeneb,
            "electra": types.ExecutionPayloadDeneb,  # structurally deneb's
        }[fork]

    def _withdrawal(self, w):
        """Accept a Withdrawal container (mock EL) or engine-API JSON."""
        if not isinstance(w, dict):
            return w
        return self.chain.types.Withdrawal(
            index=int(w["index"], 16),
            validator_index=int(w["validatorIndex"], 16),
            address=bytes.fromhex(w["address"][2:]),
            amount=int(w["amount"], 16),
        )

    def _rebuild_payload(self, header, fork: str, body: dict):
        """Header + EL payload body -> full ExecutionPayload, verified."""
        cls = self._payload_cls(fork)
        kwargs = {}
        for name in cls.fields:
            if name == "transactions":
                kwargs[name] = [bytes(t) for t in body.get("transactions", [])]
            elif name == "withdrawals":
                kwargs[name] = [
                    self._withdrawal(w) for w in (body.get("withdrawals") or [])
                ]
            else:
                kwargs[name] = getattr(header, name)
        payload = cls(**kwargs)
        rebuilt = execution_payload_to_header(payload, self.chain.types, fork)
        if rebuilt.hash_tree_root() != header.hash_tree_root():
            raise ReconstructionError(
                "EL payload body does not summarize to the stored header "
                f"(block_hash {bytes(header.block_hash).hex()[:16]})"
            )
        return payload

    def _unblind(self, signed_blinded, body: Optional[dict]):
        if body is None:
            raise ReconstructionError(
                "execution layer has no payload body for block_hash "
                + bytes(
                    signed_blinded.message.body.execution_payload_header.block_hash
                ).hex()[:16]
            )
        types = self.chain.types
        blinded = signed_blinded.message
        fork = type(blinded).fork_name
        header = blinded.body.execution_payload_header
        payload = self._rebuild_payload(header, fork, body)
        body_kwargs = {}
        for name in blinded.body.fields:
            if name == "execution_payload_header":
                body_kwargs["execution_payload"] = payload
            else:
                body_kwargs[name] = getattr(blinded.body, name)
        full = types.block[fork](
            slot=blinded.slot,
            proposer_index=blinded.proposer_index,
            parent_root=blinded.parent_root,
            state_root=blinded.state_root,
            body=types.block_body[fork](**body_kwargs),
        )
        return types.signed_block[fork](
            message=full, signature=signed_blinded.signature
        )

    # ------------------------------------------------------------- public

    def reconstruct(self, signed_blocks: Sequence) -> List:
        """Full blocks for a mixed full/blinded sequence: ONE batched
        ``engine_getPayloadBodiesByHash`` round trip covers every blinded
        entry (the reference streams ranges the same way)."""
        hashes: List[bytes] = []
        for sb in signed_blocks:
            if sb is not None and is_blinded(sb):
                hashes.append(bytes(
                    sb.message.body.execution_payload_header.block_hash
                ))
        bodies: Dict[bytes, Optional[dict]] = {}
        if hashes:
            engine = self.chain.execution_engine
            if engine is None or not hasattr(engine, "get_payload_bodies_by_hash"):
                raise ReconstructionError(
                    "no execution engine able to serve payload bodies"
                )
            for hsh, body in zip(hashes, engine.get_payload_bodies_by_hash(hashes)):
                bodies[hsh] = body
        out = []
        for sb in signed_blocks:
            if sb is None or not is_blinded(sb):
                out.append(sb)
                continue
            hsh = bytes(sb.message.body.execution_payload_header.block_hash)
            out.append(self._unblind(sb, bodies.get(hsh)))
        return out

    def reconstruct_one(self, signed_block):
        return self.reconstruct([signed_block])[0]
