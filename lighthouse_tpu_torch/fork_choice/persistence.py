"""Fork-choice persistence: snapshot/restore across restarts.

Equivalent of the reference's ``beacon_chain/src/persisted_fork_choice.rs``
(+ ``proto_array::SszContainer``): the proto array's DAG, the dense vote
tracker, checkpoints, and balances serialize to one JSON blob stored in the
hot DB, so a restarted node resumes fork choice exactly where it left off
instead of replaying from the anchor.

A copy of the JAX package's ``lighthouse_tpu/fork_choice/persistence.py``.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

from .proto_array import ProtoNode


def _hex(b: Optional[bytes]) -> Optional[str]:
    return None if b is None else bytes(b).hex()


def _unhex(s: Optional[str]) -> Optional[bytes]:
    return None if s is None else bytes.fromhex(s)


def _ckpt(c: Tuple[int, bytes]) -> list:
    return [int(c[0]), bytes(c[1]).hex()]


def _unckpt(x) -> Tuple[int, bytes]:
    return (int(x[0]), bytes.fromhex(x[1]))


def fork_choice_to_bytes(fc) -> bytes:
    proto = fc.proto
    nodes = [
        {
            "slot": int(n.slot),
            "root": _hex(n.root),
            "parent": n.parent,
            "state_root": _hex(n.state_root),
            "target_root": _hex(n.target_root),
            "jc": _ckpt(n.justified_checkpoint),
            "fc": _ckpt(n.finalized_checkpoint),
            "ujc": _ckpt(n.unrealized_justified_checkpoint),
            "ufc": _ckpt(n.unrealized_finalized_checkpoint),
            "exec": n.execution_status,
            "exec_hash": _hex(n.execution_block_hash),
            "weight": int(n.weight),
            "best_child": n.best_child,
            "best_descendant": n.best_descendant,
        }
        for n in proto.nodes
    ]
    obj = {
        "version": 1,
        "proto": {
            "nodes": nodes,
            "root_ids": {_hex(r): i for r, i in proto._root_ids.items()},
            "id_to_node": [int(x) for x in proto._id_to_node],
            "jc": _ckpt(proto.justified_checkpoint),
            "fc": _ckpt(proto.finalized_checkpoint),
        },
        "current_slot": int(fc.current_slot),
        "jc": _ckpt(fc.justified_checkpoint),
        "fc": _ckpt(fc.finalized_checkpoint),
        "ujc": _ckpt(fc.unrealized_justified_checkpoint),
        "ufc": _ckpt(fc.unrealized_finalized_checkpoint),
        "votes": {
            "current_root_id": fc.votes.current_root_id.tolist(),
            "next_root_id": fc.votes.next_root_id.tolist(),
            "next_epoch": fc.votes.next_epoch.tolist(),
            "equivocating": fc.votes.equivocating.tolist(),
        },
        "old_balances": fc._old_balances.tolist(),
        "justified_balances": np.asarray(fc.justified_balances).tolist(),
        "proposer_boost_root": _hex(fc.proposer_boost_root),
    }
    return json.dumps(obj).encode()


def restore_fork_choice(fc, raw: bytes) -> None:
    """Overwrite a freshly-anchored ForkChoice with the persisted snapshot."""
    obj = json.loads(raw)
    proto = fc.proto
    nodes = []
    for d in obj["proto"]["nodes"]:
        nodes.append(ProtoNode(
            slot=d["slot"],
            root=_unhex(d["root"]),
            parent=d["parent"],
            state_root=_unhex(d["state_root"]),
            target_root=_unhex(d["target_root"]),
            justified_checkpoint=_unckpt(d["jc"]),
            finalized_checkpoint=_unckpt(d["fc"]),
            unrealized_justified_checkpoint=_unckpt(d["ujc"]),
            unrealized_finalized_checkpoint=_unckpt(d["ufc"]),
            execution_status=d["exec"],
            execution_block_hash=_unhex(d["exec_hash"]),
            weight=d["weight"],
            best_child=d["best_child"],
            best_descendant=d["best_descendant"],
        ))
    proto.nodes = nodes
    proto.indices = {n.root: i for i, n in enumerate(nodes)}
    proto._root_ids = {_unhex(k): v for k, v in obj["proto"]["root_ids"].items()}
    proto._id_to_node = np.asarray(obj["proto"]["id_to_node"], dtype=np.int64)
    proto.justified_checkpoint = _unckpt(obj["proto"]["jc"])
    proto.finalized_checkpoint = _unckpt(obj["proto"]["fc"])

    fc.current_slot = obj["current_slot"]
    fc.justified_checkpoint = _unckpt(obj["jc"])
    fc.finalized_checkpoint = _unckpt(obj["fc"])
    fc.unrealized_justified_checkpoint = _unckpt(obj["ujc"])
    fc.unrealized_finalized_checkpoint = _unckpt(obj["ufc"])
    votes = obj["votes"]
    fc.votes.current_root_id = np.asarray(votes["current_root_id"], dtype=np.int64)
    fc.votes.next_root_id = np.asarray(votes["next_root_id"], dtype=np.int64)
    fc.votes.next_epoch = np.asarray(votes["next_epoch"], dtype=np.int64)
    fc.votes.equivocating = np.asarray(votes["equivocating"], dtype=bool)
    fc._old_balances = np.asarray(obj["old_balances"], dtype=np.int64)
    fc.justified_balances = np.asarray(obj["justified_balances"], dtype=np.int64)
    fc.proposer_boost_root = _unhex(obj["proposer_boost_root"])
