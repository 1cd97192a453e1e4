"""The beacon-node HTTP API server.

Equivalent of the reference's ``beacon_node/http_api`` crate
(``src/lib.rs`` — the warp route table, 205 routes; handlers dispatched
through the priority scheduler via ``task_spawner.rs``).  This implements the
contract surface the validator client and sync tooling need: node status,
beacon state/block queries, pool submissions, validator duties + block
production, SSE events, config, debug, and Prometheus ``/metrics``.

Transport: stdlib ``ThreadingHTTPServer`` (one thread per connection — the
Python analog of warp's task-per-request; real work still funnels through the
``BeaconProcessor`` so API load obeys the same drain order as gossip).

A copy of the JAX package's ``lighthouse_tpu/http_api/server.py``, with
every route of its table; ``POST /lighthouse/device/profile`` captures
through ``torch.profiler``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .. import __version__, metrics, tracing
from ..chain import events as ev
from ..consensus import helpers as h
from ..device_pipeline import api_arbiter_slot
from ..scheduler.admission import CLASS_DUTIES, AdmissionController, ShedError
from ..types.spec import FAR_FUTURE_EPOCH
from .response_cache import CKPT, CKPT_BLOCKS, CacheEntry, ResponseCache
from .serde import container_from_json, to_json
from .task_spawner import P0, P1, PD, OverloadedError, TaskSpawner

VERSION_STRING = f"lighthouse-tpu/{__version__}"


class ApiError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


def _not_found(what: str) -> ApiError:
    return ApiError(404, f"NOT_FOUND: {what}")


def _bad(msg: str) -> ApiError:
    return ApiError(400, f"BAD_REQUEST: {msg}")


# --------------------------------------------------------------- id parsing


def parse_root_or_slot(s: str) -> Tuple[Optional[bytes], Optional[int]]:
    if s.startswith("0x"):
        try:
            root = bytes.fromhex(s[2:])
        except ValueError:
            raise _bad(f"invalid root {s!r}")
        if len(root) != 32:
            raise _bad(f"root must be 32 bytes: {s!r}")
        return root, None
    try:
        return None, int(s)
    except ValueError:
        raise _bad(f"invalid block/state id {s!r}")


class SszResponse:
    """A handler's SSZ (application/octet-stream) answer — the server writes
    the raw bytes with Eth-Consensus-Version plus any extra headers (the
    beacon-API spec carries finality metadata as headers on SSZ answers)."""

    __slots__ = ("data", "version", "headers")

    def __init__(self, data: bytes, version: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None):
        self.data = data
        self.version = version
        self.headers = headers or {}


class Context:
    """Everything a route handler needs."""

    def __init__(self, server: "HttpApiServer", params: Dict[str, str],
                 query: Dict[str, List[str]], body: Any, headers):
        self.server = server
        self.chain = server.chain
        self.params = params
        self.query = query
        self.body = body
        self.headers = headers

    def q1(self, name: str, default: Optional[str] = None) -> Optional[str]:
        vals = self.query.get(name)
        return vals[0] if vals else default

    @property
    def wants_ssz(self) -> bool:
        """True when the client PREFERS application/octet-stream (q-values
        honored: an explicit lower/zero q on octet-stream keeps JSON)."""
        accept = self.headers.get("Accept", "") or ""
        q_octet = q_json = None
        for part in accept.split(","):
            fields = part.strip().split(";")
            mtype = fields[0].strip().lower()
            q = 1.0
            for f in fields[1:]:
                f = f.strip()
                if f.startswith("q="):
                    try:
                        q = float(f[2:])
                    except ValueError:
                        q = 0.0
            if mtype == "application/octet-stream":
                q_octet = q
            elif mtype in ("application/json", "*/*"):
                q_json = max(q_json or 0.0, q)
        if q_octet is None or q_octet <= 0:
            return False
        return q_json is None or q_octet >= q_json

    # ------------------------------------------------------- id resolution

    def resolve_block_root(self, block_id: str) -> bytes:
        chain = self.chain
        if block_id == "head":
            return chain.head_root
        if block_id == "genesis":
            return chain.genesis_block_root
        if block_id == "finalized":
            return chain.finalized_checkpoint()[1]
        if block_id == "justified":
            return chain.justified_checkpoint()[1]
        root, slot = parse_root_or_slot(block_id)
        if root is not None:
            # Existence check against the RAW store (db.get_block may return
            # a blinded block) — resolving a root must not trigger a payload
            # reconstruction round trip.
            if (
                root != chain.genesis_block_root
                and root not in chain._blocks
                and chain.db.get_block(root) is None
                and chain.early_attester_cache.get_block(root) is None
            ):
                raise _not_found(f"block {block_id}")
            return root
        found = chain.block_root_at_slot(slot)
        if found is None:
            raise _not_found(f"block at slot {slot}")
        return found

    def resolve_block(self, block_id: str):
        root = self.resolve_block_root(block_id)
        block = self.chain.get_block(root) or self.chain.db.get_block(root)
        if block is None:
            if root == self.chain.genesis_block_root:
                raise _not_found("genesis block body is not stored")
            raise _not_found(f"block {block_id}")
        return root, block

    def resolve_state(self, state_id: str):
        """Returns (state, block_root). ``state_id``: head|genesis|finalized|
        justified|<slot>|<0xstate_root>."""
        chain = self.chain
        if state_id == "head":
            return chain.head_state, chain.head_root
        if state_id == "genesis":
            return chain.genesis_state, chain.genesis_block_root
        if state_id in ("finalized", "justified"):
            _, root = (
                chain.finalized_checkpoint()
                if state_id == "finalized"
                else chain.justified_checkpoint()
            )
            state = chain.get_state(root)
            if state is None:
                raise _not_found(f"{state_id} state pruned")
            return state, root
        root, slot = parse_root_or_slot(state_id)
        if root is not None:
            for broot, st in chain._states.items():
                if st.hash_tree_root() == root:
                    return st, broot
            st = chain.db.get_hot_state(root)
            if st is None:
                raise _not_found(f"state {state_id}")
            return st, b"\x00" * 32
        head_state = chain.head_state
        if slot >= int(head_state.slot):
            state, root = chain.state_at_slot(slot)
            return state, root
        # Historical slot: resolve the canonical block at/before it and
        # advance through any empty slots.
        broot = chain.block_root_at_slot(slot)
        if broot is None:
            raise _not_found(f"state at slot {slot}")
        st = chain.get_state(broot)
        if st is None:
            raise _not_found(f"state at slot {slot} pruned from the hot cache")
        if int(st.slot) < slot:
            from ..consensus.per_slot import process_slots

            # process_slots returns a NEW object when a fork upgrade occurs
            # mid-advance — always take the return value.
            st = process_slots(st.copy(), slot, chain.types, chain.spec)
        return st, broot


# ------------------------------------------------------------------ routes

ROUTES: List[Tuple[str, str, str, Callable[[Context], Any]]] = []

#: (method, pattern) -> invalidation topics for every response-cached route.
#: The contract the static check (scripts/check_metrics.py) enforces: a
#: route may only be cached by *declaring* which chain events invalidate it
#: — there is no way to add a silently-stale route.
CACHED_ROUTES: Dict[Tuple[str, str], Tuple[str, ...]] = {}


def route(method: str, pattern: str, priority: str = P1,
          cache: Optional[Tuple[str, ...]] = None,
          klass: Optional[str] = None):
    """Register a handler.  ``cache`` (a tuple of chain-event topics, e.g.
    ``response_cache.CKPT``) opts the route into the checkpoint-keyed
    response cache AND routes its cache-miss execution through the device
    arbiter slot; ``klass`` overrides the admission class derived from
    ``priority`` (see task_spawner.DEFAULT_CLASS)."""
    segs = pattern.strip("/").split("/")

    def deco(fn):
        ROUTES.append((method, pattern, priority, fn))
        fn._segs = segs
        if cache is not None:
            fn._cache_topics = tuple(cache)
            CACHED_ROUTES[(method, pattern)] = tuple(cache)
        if klass is not None:
            fn._klass = klass
        return fn

    return deco


def match_route(method: str, path: str):
    """-> (priority, fn, params, pattern) — the pattern (route template) is
    the bounded-cardinality label the HTTP metrics series use."""
    path_segs = path.strip("/").split("/")
    for m, pattern, priority, fn in ROUTES:
        if m != method:
            continue
        segs = pattern.strip("/").split("/")
        if len(segs) != len(path_segs):
            continue
        params = {}
        ok = True
        for want, got in zip(segs, path_segs):
            if want.startswith("{") and want.endswith("}"):
                params[want[1:-1]] = got
            elif want != got:
                ok = False
                break
        if ok:
            return priority, fn, params, pattern
    return None


# ------------------------------------------------------------- node routes


@route("GET", "/eth/v1/node/version")
def node_version(ctx):
    return {"data": {"version": VERSION_STRING}}


@route("GET", "/eth/v1/node/identity")
def node_identity(ctx):
    peer_id = getattr(ctx.server, "peer_id", "") or ""
    return {"data": {
        "peer_id": peer_id,
        "enr": "",
        "p2p_addresses": [],
        "discovery_addresses": [],
        "metadata": {"seq_number": "0", "attnets": "0x" + "00" * 8, "syncnets": "0x00"},
    }}


@route("GET", "/eth/v1/node/syncing")
def node_syncing(ctx):
    chain = ctx.chain
    head_slot = chain._blocks_slot(chain.head_root)
    current = chain.current_slot()
    distance = max(0, current - head_slot)
    return {"data": {
        "head_slot": str(head_slot),
        "sync_distance": str(distance),
        "is_syncing": distance > 1,
        "is_optimistic": False,
        "el_offline": False,
    }}


@route("GET", "/eth/v1/node/health")
def node_health(ctx):
    chain = ctx.chain
    distance = chain.current_slot() - chain._blocks_slot(chain.head_root)
    raise ApiError(200 if distance <= 1 else 206, "")


# The two routes below read ``PeerManager.peers`` (a dict of ``PeerInfo``)
# and each peer's ``state``; the JAX package's copies call ``peers()`` and
# read ``info.connected``, neither of which exists, so a server given a
# real peer manager answers 500 there.


@route("GET", "/eth/v1/node/peers")
def node_peers(ctx):
    from ..network.peer_manager import ConnectionState

    peers = []
    pm = getattr(ctx.server, "peer_manager", None)
    if pm is not None:
        for pid, info in list(pm.peers.items()):
            peers.append({
                "peer_id": str(pid),
                "enr": "",
                "last_seen_p2p_address": "",
                "state": ("connected" if info.state == ConnectionState.CONNECTED
                          else "disconnected"),
                "direction": "outbound",
            })
    return {"data": peers, "meta": {"count": len(peers)}}


@route("GET", "/eth/v1/node/peer_count")
def node_peer_count(ctx):
    pm = getattr(ctx.server, "peer_manager", None)
    n = len(pm.connected_peers()) if pm else 0
    return {"data": {
        "connected": str(n), "connecting": "0", "disconnected": "0", "disconnecting": "0",
    }}


# ----------------------------------------------------------- beacon routes


@route("GET", "/eth/v1/beacon/genesis")
def beacon_genesis(ctx):
    chain = ctx.chain
    return {"data": {
        "genesis_time": str(chain.genesis_time),
        "genesis_validators_root": "0x" + chain.genesis_validators_root.hex(),
        "genesis_fork_version": "0x" + chain.spec.genesis_fork_version.hex(),
    }}


def _finality_meta(ctx, block_root):
    f_epoch, f_root = ctx.chain.finalized_checkpoint()
    try:
        slot = ctx.chain._blocks_slot(block_root)
        finalized = slot <= f_epoch * ctx.chain.spec.slots_per_epoch
    except KeyError:
        finalized = False
    return {"execution_optimistic": False, "finalized": finalized}


@route("GET", "/eth/v1/beacon/states/{state_id}/root", cache=CKPT)
def state_root(ctx):
    state, broot = ctx.resolve_state(ctx.params["state_id"])
    out = {"data": {"root": "0x" + state.hash_tree_root().hex()}}
    out.update(_finality_meta(ctx, broot))
    return out


@route("GET", "/eth/v1/beacon/states/{state_id}/fork", cache=CKPT)
def state_fork(ctx):
    state, broot = ctx.resolve_state(ctx.params["state_id"])
    out = {"data": to_json(state.fork)}
    out.update(_finality_meta(ctx, broot))
    return out


@route("GET", "/eth/v1/beacon/states/{state_id}/finality_checkpoints", cache=CKPT)
def state_finality(ctx):
    state, broot = ctx.resolve_state(ctx.params["state_id"])
    out = {"data": {
        "previous_justified": to_json(state.previous_justified_checkpoint),
        "current_justified": to_json(state.current_justified_checkpoint),
        "finalized": to_json(state.finalized_checkpoint),
    }}
    out.update(_finality_meta(ctx, broot))
    return out


def validator_status(v, balance: int, epoch: int) -> str:
    """The standard beacon-API validator status taxonomy
    (reference ``consensus/types/src/validator.rs`` + api spec)."""
    if epoch < int(v.activation_eligibility_epoch):
        return "pending_initialized"
    if epoch < int(v.activation_epoch):
        return "pending_queued"
    if epoch < int(v.exit_epoch):
        if int(v.exit_epoch) == FAR_FUTURE_EPOCH:
            return "active_ongoing"
        return "active_slashed" if v.slashed else "active_exiting"
    if epoch < int(v.withdrawable_epoch):
        return "exited_slashed" if v.slashed else "exited_unslashed"
    return "withdrawal_possible" if balance > 0 else "withdrawal_done"


def _validator_entry(state, i: int, epoch: int) -> dict:
    v = state.validators[i]
    bal = int(state.balances[i])
    return {
        "index": str(i),
        "balance": str(bal),
        "status": validator_status(v, bal, epoch),
        "validator": to_json(v),
    }


def _parse_validator_id(state, vid: str) -> Optional[int]:
    if vid.startswith("0x"):
        pk = bytes.fromhex(vid[2:])
        for i, v in enumerate(state.validators):
            if bytes(v.pubkey) == pk:
                return i
        return None
    idx = int(vid)
    return idx if 0 <= idx < len(state.validators) else None


@route("GET", "/eth/v1/beacon/states/{state_id}/validators", cache=CKPT)
def state_validators(ctx):
    state, broot = ctx.resolve_state(ctx.params["state_id"])
    epoch = h.get_current_epoch(state, ctx.chain.spec)
    ids = ctx.query.get("id")
    statuses = set(ctx.query.get("status", []))
    if ids:
        wanted = []
        for vid in ids:
            for part in vid.split(","):
                i = _parse_validator_id(state, part)
                if i is not None:
                    wanted.append(i)
    else:
        wanted = range(len(state.validators))
    data = [_validator_entry(state, i, epoch) for i in wanted]
    if statuses:
        data = [d for d in data if d["status"] in statuses]
    out = {"data": data}
    out.update(_finality_meta(ctx, broot))
    return out


@route("POST", "/eth/v1/beacon/states/{state_id}/validators", cache=CKPT)
def state_validators_post(ctx):
    body = ctx.body or {}
    ctx.query = dict(ctx.query)
    if body.get("ids"):
        ctx.query["id"] = [str(x) for x in body["ids"]]
    if body.get("statuses"):
        ctx.query["status"] = list(body["statuses"])
    return state_validators(ctx)


@route("GET", "/eth/v1/beacon/states/{state_id}/validators/{validator_id}", cache=CKPT)
def state_validator(ctx):
    state, broot = ctx.resolve_state(ctx.params["state_id"])
    epoch = h.get_current_epoch(state, ctx.chain.spec)
    i = _parse_validator_id(state, ctx.params["validator_id"])
    if i is None:
        raise _not_found(f"validator {ctx.params['validator_id']}")
    out = {"data": _validator_entry(state, i, epoch)}
    out.update(_finality_meta(ctx, broot))
    return out


@route("GET", "/eth/v1/beacon/states/{state_id}/validator_balances", cache=CKPT)
def state_balances(ctx):
    state, broot = ctx.resolve_state(ctx.params["state_id"])
    ids = ctx.query.get("id")
    if ids:
        wanted = []
        for vid in ids:
            for part in vid.split(","):
                i = _parse_validator_id(state, part)
                if i is not None:
                    wanted.append(i)
    else:
        wanted = range(len(state.balances))
    out = {"data": [
        {"index": str(i), "balance": str(int(state.balances[i]))} for i in wanted
    ]}
    out.update(_finality_meta(ctx, broot))
    return out


@route("GET", "/eth/v1/beacon/states/{state_id}/committees", cache=CKPT)
def state_committees(ctx):
    state, broot = ctx.resolve_state(ctx.params["state_id"])
    spec = ctx.chain.spec
    epoch = (
        int(ctx.q1("epoch"))
        if ctx.q1("epoch") is not None
        else h.get_current_epoch(state, spec)
    )
    want_index = ctx.q1("index")
    want_slot = ctx.q1("slot")
    data = []
    for slot in range(
        epoch * spec.slots_per_epoch, (epoch + 1) * spec.slots_per_epoch
    ):
        if want_slot is not None and slot != int(want_slot):
            continue
        count = h.get_committee_count_per_slot(state, epoch, spec)
        for index in range(count):
            if want_index is not None and index != int(want_index):
                continue
            committee = h.get_beacon_committee(state, slot, index, spec)
            data.append({
                "index": str(index),
                "slot": str(slot),
                "validators": [str(int(v)) for v in committee],
            })
    out = {"data": data}
    out.update(_finality_meta(ctx, broot))
    return out


@route("GET", "/eth/v1/beacon/states/{state_id}/sync_committees", cache=CKPT)
def state_sync_committees(ctx):
    state, broot = ctx.resolve_state(ctx.params["state_id"])
    if not hasattr(state, "current_sync_committee"):
        raise _bad("state has no sync committees (phase0)")
    pk_to_index = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
    indices = [
        pk_to_index[bytes(pk)] for pk in state.current_sync_committee.pubkeys
    ]
    sub_size = max(1, len(indices) // 4)
    out = {"data": {
        "validators": [str(i) for i in indices],
        "validator_aggregates": [
            [str(i) for i in indices[k : k + sub_size]]
            for k in range(0, len(indices), sub_size)
        ],
    }}
    out.update(_finality_meta(ctx, broot))
    return out


@route("GET", "/eth/v1/beacon/states/{state_id}/randao", cache=CKPT)
def state_randao(ctx):
    state, broot = ctx.resolve_state(ctx.params["state_id"])
    spec = ctx.chain.spec
    epoch = (
        int(ctx.q1("epoch"))
        if ctx.q1("epoch") is not None
        else h.get_current_epoch(state, spec)
    )
    mix = h.get_randao_mix(state, epoch, spec)
    out = {"data": {"randao": "0x" + bytes(mix).hex()}}
    out.update(_finality_meta(ctx, broot))
    return out


def _header_json(ctx, root: bytes, signed_block) -> dict:
    msg = signed_block.message
    header = {
        "slot": str(int(msg.slot)),
        "proposer_index": str(int(msg.proposer_index)),
        "parent_root": "0x" + bytes(msg.parent_root).hex(),
        "state_root": "0x" + bytes(msg.state_root).hex(),
        "body_root": "0x" + msg.body.hash_tree_root().hex(),
    }
    return {
        "root": "0x" + root.hex(),
        "canonical": ctx.chain.block_root_at_slot(int(msg.slot)) == root,
        "header": {
            "message": header,
            "signature": "0x" + bytes(signed_block.signature).hex(),
        },
    }


@route("GET", "/eth/v1/beacon/headers", cache=CKPT_BLOCKS)
def beacon_headers(ctx):
    slot = ctx.q1("slot")
    parent_root = ctx.q1("parent_root")
    chain = ctx.chain
    results = []
    if slot is not None:
        root = chain.block_root_at_slot(int(slot))
        if root is not None and chain.get_block(root) is not None:
            results.append((root, chain.get_block(root)))
    elif parent_root is not None:
        want = bytes.fromhex(parent_root[2:])
        for root, blk in chain._blocks.items():
            if bytes(blk.message.parent_root) == want:
                results.append((root, blk))
    else:
        root = chain.head_root
        blk = chain.get_block(root)
        if blk is not None:
            results.append((root, blk))
    return {
        "data": [_header_json(ctx, r, b) for r, b in results],
        "execution_optimistic": False,
        "finalized": False,
    }


@route("GET", "/eth/v1/beacon/headers/{block_id}", cache=CKPT)
def beacon_header(ctx):
    root, block = ctx.resolve_block(ctx.params["block_id"])
    out = {"data": _header_json(ctx, root, block)}
    out.update(_finality_meta(ctx, root))
    return out


@route("GET", "/eth/v2/beacon/blocks/{block_id}", cache=CKPT)
def beacon_block(ctx):
    root, block = ctx.resolve_block(ctx.params["block_id"])
    fork = type(block.message).fork_name
    if ctx.wants_ssz:
        meta = _finality_meta(ctx, root)
        return SszResponse(block.as_ssz_bytes(), fork, headers={
            "Eth-Execution-Optimistic": str(meta.get("execution_optimistic", False)).lower(),
            "Eth-Finalized": str(meta.get("finalized", False)).lower(),
        })
    out = {
        "version": fork,
        "data": to_json(block),
    }
    out.update(_finality_meta(ctx, root))
    return out


@route("GET", "/eth/v1/beacon/blocks/{block_id}", cache=CKPT)
def beacon_block_v1(ctx):
    """v1 block fetch: bare {data} envelope (reference get_beacon_block is
    version-generic via any_version; V1 responses carry no version key)."""
    root, block = ctx.resolve_block(ctx.params["block_id"])
    fork = type(block.message).fork_name
    if ctx.wants_ssz:
        return SszResponse(block.as_ssz_bytes(), fork)
    return {"data": to_json(block)}


@route("GET", "/eth/v1/beacon/blocks/{block_id}/root", cache=CKPT)
def beacon_block_root(ctx):
    root = ctx.resolve_block_root(ctx.params["block_id"])
    out = {"data": {"root": "0x" + root.hex()}}
    out.update(_finality_meta(ctx, root))
    return out


@route("GET", "/eth/v1/beacon/blocks/{block_id}/attestations", cache=CKPT)
def beacon_block_attestations(ctx):
    root, block = ctx.resolve_block(ctx.params["block_id"])
    out = {"data": [to_json(a) for a in block.message.body.attestations]}
    out.update(_finality_meta(ctx, root))
    return out


@route("GET", "/eth/v1/beacon/blob_sidecars/{block_id}")
def beacon_blob_sidecars(ctx):
    root, _ = ctx.resolve_block(ctx.params["block_id"])
    sidecars = ctx.chain.get_blobs(root) if hasattr(ctx.chain, "get_blobs") else []
    indices = ctx.query.get("indices")
    if indices:
        want = {int(i) for x in indices for i in x.split(",")}
        sidecars = [s for s in sidecars if int(s.index) in want]
    return {"data": [to_json(s) for s in sidecars]}


def _decode_ssz_signed_block(ctx, body: bytes, registry) -> Any:
    """SSZ block upload: version from the consensus-version header, else
    derived from the slot at its fixed offset (message offset word ++
    96-byte signature ++ slot u64 = bytes 100..108) — the same decision the
    JSON path makes; never guess-and-swallow across forks."""
    types, spec = ctx.chain.types, ctx.chain.spec
    version = ctx.headers.get("Eth-Consensus-Version")  # case-insensitive get
    if version is None:
        if len(body) < 108:
            raise _bad("SSZ block too short")
        slot = int.from_bytes(body[100:108], "little")
        version = spec.fork_name_at_slot(slot)
    cls = registry.get(str(version).lower())
    if cls is None:
        raise _bad(f"unknown consensus version {version!r}")
    try:
        return cls.from_ssz_bytes(bytes(body))
    except (ValueError, IndexError) as e:
        raise _bad(f"malformed SSZ block: {e}")


def _signed_block_from_json(ctx, body) -> Any:
    types, spec = ctx.chain.types, ctx.chain.spec
    if isinstance(body, (bytes, bytearray)):
        return _decode_ssz_signed_block(ctx, bytes(body), types.signed_block)
    version = None
    for k in ("Eth-Consensus-Version", "eth-consensus-version"):
        if ctx.headers.get(k):
            version = ctx.headers.get(k).lower()
            break
    if version is None:
        slot = int(body["message"]["slot"])
        version = spec.fork_name_at_slot(slot)
    cls = types.signed_block.get(version)
    if cls is None:
        raise _bad(f"unknown consensus version {version!r}")
    try:
        return container_from_json(cls, body)
    except (KeyError, TypeError, ValueError) as e:
        raise _bad(f"malformed {version} SignedBeaconBlock body: {e}")


def _import_and_publish_block(ctx, signed_block):
    from ..chain.beacon_chain import BlockError

    chain = ctx.chain
    try:
        chain.process_block(signed_block)
    except BlockError as e:
        if "unknown parent" in str(e):
            raise ApiError(202, f"block queued: {e}")
        raise _bad(f"invalid block: {e}")
    publish = getattr(ctx.server, "publish_block_fn", None)
    if publish is not None:
        publish(signed_block)
    return None


@route("POST", "/eth/v1/beacon/blocks", P0)
def publish_block_v1(ctx):
    return _import_and_publish_block(ctx, _signed_block_from_json(ctx, ctx.body))


publish_block_v1._accepts_ssz = True


@route("POST", "/eth/v2/beacon/blocks", P0)
def publish_block_v2(ctx):
    return _import_and_publish_block(ctx, _signed_block_from_json(ctx, ctx.body))


publish_block_v2._accepts_ssz = True


# -------------------------------------------------------------- pool routes


def _submit_attestations(ctx, att_cls) -> None:
    from ..chain.beacon_chain import AttestationError

    chain = ctx.chain
    failures = []
    for i, att_json in enumerate(ctx.body or []):
        try:
            att = container_from_json(att_cls, att_json)
            chain.process_attestation(att)
            publish = getattr(ctx.server, "publish_attestation_fn", None)
            if publish is not None:
                publish(att)
        except (AttestationError, KeyError, ValueError) as e:
            failures.append({"index": i, "message": str(e)})
    if failures:
        raise ApiError(400, json.dumps({
            "code": 400,
            "message": "error processing attestations",
            "failures": failures,
        }))


@route("POST", "/eth/v1/beacon/pool/attestations", P0)
def pool_attestations_post(ctx):
    return _submit_attestations(ctx, ctx.chain.types.Attestation)


@route("POST", "/eth/v2/beacon/pool/attestations", P0)
def pool_attestations_post_v2(ctx):
    """v2 submission (electra, EIP-7549): the Eth-Consensus-Version header
    selects the per-fork attestation container (committee_bits form for
    electra)."""
    version = (ctx.headers.get("Eth-Consensus-Version") or "").lower()
    att_cls = ctx.chain.types.attestation_by_fork.get(
        version, ctx.chain.types.Attestation
    )
    return _submit_attestations(ctx, att_cls)


@route("POST", "/eth/v1/beacon/pool/sync_committees", P0)
def pool_sync_committees_post(ctx):
    """Submit ``SyncCommitteeMessage``s (the VC's slot+1/3 sync duty)."""
    from ..chain.beacon_chain import AttestationError

    chain = ctx.chain
    failures = []
    messages = []
    slots = []  # original body index per decoded message
    for i, msg_json in enumerate(ctx.body or []):
        try:
            messages.append(
                container_from_json(chain.types.SyncCommitteeMessage, msg_json)
            )
            slots.append(i)
        except (KeyError, ValueError) as e:
            failures.append({"index": i, "message": str(e)})
    # ONE batched verification for the whole submission (a per-message
    # pairing would put a full committee's POST past client timeouts).
    for i, err in zip(slots, chain.process_sync_committee_messages(messages)):
        if err is not None:
            failures.append({"index": i, "message": err})
    if failures:
        raise ApiError(400, json.dumps({
            "code": 400,
            "message": "error processing sync committee messages",
            "failures": failures,
        }))
    return None


@route("GET", "/eth/v1/validator/sync_committee_contribution", P0)
def sync_committee_contribution(ctx):
    slot = ctx.q1("slot")
    sub = ctx.q1("subcommittee_index")
    root_hex = ctx.q1("beacon_block_root")
    if slot is None or sub is None or root_hex is None:
        raise _bad("slot, subcommittee_index and beacon_block_root are required")
    c = ctx.chain.sync_contribution_pool.get_contribution(
        int(slot), bytes.fromhex(root_hex[2:]), int(sub)
    )
    if c is None:
        raise _not_found("no contribution for that subcommittee")
    return {"data": to_json(c)}


@route("POST", "/eth/v1/validator/contribution_and_proofs", P0)
def contribution_and_proofs(ctx):
    from ..chain.beacon_chain import AttestationError

    chain = ctx.chain
    failures = []
    signed_list = []
    idxs = []
    for i, c_json in enumerate(ctx.body or []):
        try:
            signed_list.append(container_from_json(
                chain.types.SignedContributionAndProof, c_json
            ))
            idxs.append(i)
        except (KeyError, ValueError) as e:
            failures.append({"index": i, "message": str(e)})
    # ONE batched verification (3 sets per contribution) per submission.
    for i, err in zip(idxs, chain.process_signed_contributions(signed_list)):
        if err is not None:
            failures.append({"index": i, "message": err})
    if failures:
        raise ApiError(400, json.dumps({
            "code": 400,
            "message": "error processing contributions",
            "failures": failures,
        }))
    return None


@route("POST", "/eth/v1/validator/liveness/{epoch}", P0)
def validator_liveness(ctx):
    """Per-validator liveness for ``epoch`` — the doppelganger service's
    data source.  ORs every observed cache that can prove activity (gossip
    attesters, block-included attesters, aggregators, block proposers),
    matching the reference's four-cache ``validator_seen_at_epoch``
    (beacon_chain.rs:6615): a duplicate instance whose attestations reach
    this node only inside aggregates or blocks must still read live."""
    epoch = int(ctx.params["epoch"])
    chain = ctx.chain
    out = []
    for raw in (ctx.body or []):
        idx = int(raw)
        out.append({
            "index": str(idx),
            "is_live": bool(chain.observed.validator_seen_at_epoch(
                epoch, idx, chain.spec.slots_per_epoch)),
        })
    return {"data": out}


def _pool_attestations(ctx):
    atts = list(ctx.chain.attestation_pool._pool.values())
    slot = ctx.q1("slot")
    index = ctx.q1("committee_index")
    if slot is not None:
        atts = [a for a in atts if int(a.data.slot) == int(slot)]
    if index is not None:
        atts = [a for a in atts if int(a.data.index) == int(index)]
    return atts


@route("GET", "/eth/v1/beacon/pool/attestations")
def pool_attestations_get(ctx):
    return {"data": [to_json(a) for a in _pool_attestations(ctx)]}


@route("GET", "/eth/v2/beacon/pool/attestations")
def pool_attestations_get_v2(ctx):
    """v2 wraps the pool dump in a version envelope (electra-era API)."""
    chain = ctx.chain
    version = chain.spec.fork_name_at_slot(chain.current_slot())
    return {"version": version,
            "data": [to_json(a) for a in _pool_attestations(ctx)]}


def _publish_op(ctx, kind: str, op) -> None:
    """Gossip a freshly-pooled operation out (reference publish flow); a
    node without networking simply has no hook installed."""
    publish = getattr(ctx.server, "publish_operation_fn", None)
    if publish is not None:
        publish(kind, op)


@route("POST", "/eth/v1/beacon/pool/voluntary_exits", P0)
def pool_exits_post(ctx):
    from ..chain.beacon_chain import ChainError

    chain = ctx.chain
    exit_ = container_from_json(chain.types.SignedVoluntaryExit, ctx.body)
    # Validation + dedup + pooling + SSE share ONE owner with the gossip
    # path (the reference's verify_operation path).
    try:
        fresh = chain.on_gossip_voluntary_exit(exit_)
    except ChainError as e:
        raise _bad(str(e))
    if fresh:
        _publish_op(ctx, "voluntary_exit", exit_)
    return None


@route("GET", "/eth/v1/beacon/pool/voluntary_exits")
def pool_exits_get(ctx):
    return {"data": [to_json(e) for e in ctx.chain.op_pool._voluntary_exits.values()]}


@route("POST", "/eth/v1/beacon/pool/proposer_slashings", P0)
def pool_proposer_slashings_post(ctx):
    from ..chain.beacon_chain import ChainError

    chain = ctx.chain
    slashing = container_from_json(chain.types.ProposerSlashing, ctx.body)
    try:
        fresh = chain.on_gossip_proposer_slashing(slashing)
    except ChainError as e:
        raise _bad(str(e))
    if fresh:
        _publish_op(ctx, "proposer_slashing", slashing)
    return None


@route("GET", "/eth/v1/beacon/pool/proposer_slashings")
def pool_proposer_slashings_get(ctx):
    return {"data": [to_json(s) for s in ctx.chain.op_pool._proposer_slashings.values()]}


@route("POST", "/eth/v1/beacon/pool/attester_slashings", P0)
def pool_attester_slashings_post(ctx):
    from ..chain.beacon_chain import ChainError

    chain = ctx.chain
    slashing = container_from_json(chain.types.AttesterSlashing, ctx.body)
    try:
        fresh = chain.on_gossip_attester_slashing(slashing)
    except ChainError as e:
        raise _bad(str(e))
    if fresh:
        _publish_op(ctx, "attester_slashing", slashing)
    return None


@route("GET", "/eth/v1/beacon/pool/attester_slashings")
def pool_attester_slashings_get(ctx):
    return {"data": [to_json(s) for s in ctx.chain.op_pool.attester_slashings()]}


@route("POST", "/eth/v2/beacon/pool/attester_slashings", P0)
def pool_attester_slashings_post_v2(ctx):
    """v2 submission: Eth-Consensus-Version selects the per-fork container
    (electra slashings carry IndexedAttestationElectra)."""
    chain = ctx.chain
    version = (ctx.headers.get("Eth-Consensus-Version") or "").lower()
    from ..chain.beacon_chain import ChainError

    cls = (chain.types.AttesterSlashingElectra if version == "electra"
           else chain.types.AttesterSlashing)
    slashing = container_from_json(cls, ctx.body)
    try:
        fresh = chain.on_gossip_attester_slashing(slashing)
    except ChainError as e:
        raise _bad(str(e))
    if fresh:
        _publish_op(ctx, "attester_slashing", slashing)
    return None


@route("GET", "/eth/v2/beacon/pool/attester_slashings")
def pool_attester_slashings_get_v2(ctx):
    chain = ctx.chain
    version = chain.spec.fork_name_at_slot(chain.current_slot())
    return {"version": version,
            "data": [to_json(s) for s in chain.op_pool.attester_slashings()]}


@route("POST", "/eth/v1/beacon/pool/bls_to_execution_changes", P0)
def pool_bls_changes_post(ctx):
    from ..chain.beacon_chain import ChainError

    chain = ctx.chain
    # Beacon-API batch contract: process EVERY item, report per-index
    # failures — one bad change must not drop the valid ones after it.
    failures = []
    scratch = chain.head_state.copy() if ctx.body else None  # one copy per batch
    for i, change_json in enumerate(ctx.body or []):
        try:
            change = container_from_json(
                chain.types.SignedBLSToExecutionChange, change_json)
            fresh = chain.on_gossip_bls_change(change, scratch=scratch)
        except (ChainError, KeyError, ValueError, TypeError) as e:
            failures.append({"index": i, "message": str(e)})
            continue
        if fresh:
            _publish_op(ctx, "bls_to_execution_change", change)
    if failures:
        raise ApiError(400, json.dumps({
            "code": 400,
            "message": "error processing bls_to_execution_changes",
            "failures": failures,
        }))
    return None


# --------------------------------------------------------- validator routes


def _advance_to_epoch(ctx, epoch: int):
    """Head state advanced (empty slots) to the start of ``epoch``."""
    chain = ctx.chain
    spec = chain.spec
    state = chain.head_state
    target = epoch * spec.slots_per_epoch
    if int(state.slot) < target:
        state, _ = chain.state_at_slot(target)
    return state


def _dependent_root(ctx, epoch: int) -> bytes:
    """Block root the duties depend on (last block before epoch start)."""
    chain = ctx.chain
    slot = epoch * chain.spec.slots_per_epoch
    if slot == 0:
        return chain.genesis_block_root
    root = chain.block_root_at_slot(slot - 1)
    return root if root is not None else chain.genesis_block_root


@route("GET", "/eth/v1/validator/duties/proposer/{epoch}", PD, cache=CKPT)
def duties_proposer(ctx):
    chain = ctx.chain
    spec = chain.spec
    epoch = int(ctx.params["epoch"])
    state = _advance_to_epoch(ctx, epoch)
    duties = []
    state = state.copy()
    from ..consensus.per_slot import process_slots

    for slot in range(epoch * spec.slots_per_epoch, (epoch + 1) * spec.slots_per_epoch):
        if int(state.slot) < slot:
            process_slots(state, slot, chain.types, spec)
        proposer = h.get_beacon_proposer_index(state, spec, slot=slot)
        duties.append({
            "pubkey": "0x" + bytes(state.validators[proposer].pubkey).hex(),
            "validator_index": str(proposer),
            "slot": str(slot),
        })
    return {
        "dependent_root": "0x" + _dependent_root(ctx, epoch).hex(),
        "execution_optimistic": False,
        "data": duties,
    }


@route("POST", "/eth/v1/validator/duties/attester/{epoch}", PD, cache=CKPT)
def duties_attester(ctx):
    chain = ctx.chain
    spec = chain.spec
    epoch = int(ctx.params["epoch"])
    indices = [int(i) for i in (ctx.body or [])]
    state = _advance_to_epoch(ctx, epoch)
    committees_per_slot = h.get_committee_count_per_slot(state, epoch, spec)
    wanted = set(indices)
    duties = []
    for slot in range(epoch * spec.slots_per_epoch, (epoch + 1) * spec.slots_per_epoch):
        for index in range(committees_per_slot):
            committee = h.get_beacon_committee(state, slot, index, spec)
            for pos, vidx in enumerate(committee):
                if int(vidx) in wanted:
                    duties.append({
                        "pubkey": "0x" + bytes(state.validators[int(vidx)].pubkey).hex(),
                        "validator_index": str(int(vidx)),
                        "committee_index": str(index),
                        "committee_length": str(len(committee)),
                        "committees_at_slot": str(committees_per_slot),
                        "validator_committee_index": str(pos),
                        "slot": str(slot),
                    })
    return {
        "dependent_root": "0x" + _dependent_root(ctx, max(epoch - 1, 0)).hex(),
        "execution_optimistic": False,
        "data": duties,
    }


@route("POST", "/eth/v1/validator/duties/sync/{epoch}", PD, cache=CKPT)
def duties_sync(ctx):
    chain = ctx.chain
    epoch = int(ctx.params["epoch"])
    indices = {int(i) for i in (ctx.body or [])}
    state = _advance_to_epoch(ctx, epoch)
    if not hasattr(state, "current_sync_committee"):
        return {"data": [], "execution_optimistic": False}
    pk_to_index = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
    duties: Dict[int, List[int]] = {}
    for pos, pk in enumerate(state.current_sync_committee.pubkeys):
        vidx = pk_to_index.get(bytes(pk))
        if vidx is not None and vidx in indices:
            duties.setdefault(vidx, []).append(pos)
    return {
        "execution_optimistic": False,
        "data": [
            {
                "pubkey": "0x" + bytes(state.validators[vidx].pubkey).hex(),
                "validator_index": str(vidx),
                "validator_sync_committee_indices": [str(p) for p in positions],
            }
            for vidx, positions in duties.items()
        ],
    }


@route("GET", "/eth/v3/validator/blocks/{slot}", P0)
def produce_block_v3(ctx):
    """v3 production: builder path when a relay is configured and bids
    (reference ``produce_block.rs`` local-vs-builder choice — builder first,
    local fallback on any failure)."""
    from ..chain.beacon_chain import ChainError

    chain = ctx.chain
    slot = int(ctx.params["slot"])
    reveal = ctx.q1("randao_reveal")
    if reveal is None:
        raise _bad("randao_reveal is required")
    graffiti = ctx.q1("graffiti")
    kwargs = {}
    if graffiti:
        kwargs["graffiti"] = bytes.fromhex(graffiti[2:]).ljust(32, b"\x00")
    blinded = False
    block = None
    if chain.builder is not None and ctx.q1("builder_boost_factor") != "0":
        try:
            block, _ = chain.produce_blinded_block(
                slot, bytes.fromhex(reveal[2:]), **kwargs
            )
            blinded = True
        except ChainError:
            block = None  # fall back to local production
    if block is None:
        block, _ = chain.produce_block(slot, bytes.fromhex(reveal[2:]), **kwargs)
    return {
        "version": type(block).fork_name,
        "execution_payload_blinded": blinded,
        "execution_payload_value": "0",
        "consensus_block_value": "0",
        "data": to_json(block),
    }


@route("GET", "/eth/v1/validator/blinded_blocks/{slot}", P0)
def produce_blinded_block_route(ctx):
    chain = ctx.chain
    slot = int(ctx.params["slot"])
    reveal = ctx.q1("randao_reveal")
    if reveal is None:
        raise _bad("randao_reveal is required")
    graffiti = ctx.q1("graffiti")
    kwargs = {}
    if graffiti:
        kwargs["graffiti"] = bytes.fromhex(graffiti[2:]).ljust(32, b"\x00")
    from ..chain.beacon_chain import ChainError

    try:
        block, _ = chain.produce_blinded_block(
            slot, bytes.fromhex(reveal[2:]), **kwargs
        )
    except ChainError as e:
        raise _bad(f"blinded production failed: {e}")
    return {"version": type(block).fork_name, "data": to_json(block)}


@route("POST", "/eth/v1/beacon/blinded_blocks", P0)
@route("POST", "/eth/v2/beacon/blinded_blocks", P0)
def publish_blinded_block(ctx):
    from ..chain.beacon_chain import BlockError, ChainError

    chain = ctx.chain
    if isinstance(ctx.body, (bytes, bytearray)):
        signed = _decode_ssz_signed_block(
            ctx, bytes(ctx.body), chain.types.signed_blinded_block
        )
    else:
        version = ctx.headers.get("Eth-Consensus-Version")
        if version is None:
            version = chain.spec.fork_name_at_slot(int(ctx.body["message"]["slot"]))
        cls = chain.types.signed_blinded_block.get(str(version).lower())
        if cls is None:
            raise _bad(f"unknown consensus version {version!r}")
        try:
            signed = container_from_json(cls, ctx.body)
        except (KeyError, TypeError, ValueError) as e:
            raise _bad(f"malformed SignedBlindedBeaconBlock: {e}")
    try:
        _root, signed_full = chain.unblind_and_import(signed)
    except (BlockError, ChainError) as e:
        raise _bad(f"invalid blinded block: {e}")
    publish = getattr(ctx.server, "publish_block_fn", None)
    if publish is not None:
        publish(signed_full)
    return None


publish_blinded_block._accepts_ssz = True


@route("POST", "/eth/v1/validator/register_validator", P0)
def register_validator(ctx):
    """Forward fee-recipient registrations to the configured relay
    (reference ``register_validators`` passthrough); a no-op without one."""
    chain = ctx.chain
    if chain.builder is None:
        return None
    regs = [
        container_from_json(chain.types.SignedValidatorRegistrationV1, r)
        for r in (ctx.body or [])
    ]
    from ..execution_layer.builder_client import BuilderError

    try:
        chain.builder.register_validators(regs)
    except BuilderError as e:
        raise ApiError(502, json.dumps({"code": 502, "message": str(e)}))
    return None


@route("GET", "/eth/v1/validator/attestation_data", P0)
def attestation_data(ctx):
    slot = ctx.q1("slot")
    committee_index = ctx.q1("committee_index")
    if slot is None or committee_index is None:
        raise _bad("slot and committee_index are required")
    data = ctx.chain.produce_attestation_data(int(slot), int(committee_index))
    return {"data": to_json(data)}


@route("GET", "/eth/v1/validator/aggregate_attestation", P0)
@route("GET", "/eth/v2/validator/aggregate_attestation", P0)
def aggregate_attestation(ctx):
    root_hex = ctx.q1("attestation_data_root")
    slot = ctx.q1("slot")
    committee_index = ctx.q1("committee_index")  # v2 (electra) parameter
    if root_hex is None or slot is None:
        raise _bad("attestation_data_root and slot are required")
    att = ctx.chain.attestation_pool.get_aggregate(
        int(slot), bytes.fromhex(root_hex[2:]),
        committee_index=None if committee_index is None else int(committee_index),
    )
    if att is None:
        raise _not_found("no aggregate for that data root")
    return {"data": to_json(att)}


@route("POST", "/eth/v1/validator/aggregate_and_proofs", P0)
@route("POST", "/eth/v2/validator/aggregate_and_proofs", P0)
def aggregate_and_proofs(ctx):
    from ..chain.beacon_chain import AttestationError

    chain = ctx.chain
    failures = []
    for i, agg_json in enumerate(ctx.body or []):
        try:
            signed = container_from_json(chain.types.SignedAggregateAndProof, agg_json)
            chain.process_aggregate(signed)
        except (AttestationError, KeyError, ValueError) as e:
            failures.append({"index": i, "message": str(e)})
    if failures:
        raise ApiError(400, json.dumps({
            "code": 400,
            "message": "error processing aggregates",
            "failures": failures,
        }))
    return None


@route("POST", "/eth/v1/validator/beacon_committee_subscriptions", P0)
def committee_subscriptions(ctx):
    """Feed aggregator duty subscriptions to the subnet service (reference
    subnet_service/attestation_subnets.rs); a no-op when the node runs
    without networking (or with --subscribe-all-subnets)."""
    subnets = getattr(ctx.server, "subnet_service", None)
    if subnets is not None:
        subnets.on_committee_subscriptions(ctx.body or [])
    return None


@route("POST", "/eth/v1/validator/sync_committee_subscriptions", P0)
def sync_subscriptions(ctx):
    subnets = getattr(ctx.server, "subnet_service", None)
    if subnets is not None:
        subnets.on_sync_committee_subscriptions(ctx.body or [])
    return None


@route("POST", "/eth/v1/validator/prepare_beacon_proposer", P0)
def prepare_proposer(ctx):
    """Record per-validator fee recipients (reference proposer_prep_service:
    the VC's PreparationService posts these each epoch; payload production
    consumes them)."""
    chain = ctx.chain
    for entry in (ctx.body or []):
        try:
            idx = int(entry["validator_index"])
            recipient = bytes.fromhex(entry["fee_recipient"][2:])
        except (KeyError, TypeError, ValueError) as e:
            raise _bad(f"malformed preparation entry: {e}")
        if len(recipient) != 20:
            raise _bad("fee_recipient must be 20 bytes")
        chain.proposer_preparations[idx] = recipient
    return None


# ------------------------------------------------------------ config routes


def _validator_indices(state, raw_ids):
    """Beacon-API validator ids: indices or 0x-pubkeys -> index list (400 on
    junk), None when the body is empty (= all validators)."""
    if not raw_ids:
        return None
    out = []
    pk_to_idx = None
    for item in raw_ids:
        s = str(item)
        if s.startswith("0x"):
            if pk_to_idx is None:
                pk_to_idx = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
            try:
                idx = pk_to_idx.get(bytes.fromhex(s[2:]))
            except ValueError:
                raise _bad(f"invalid pubkey {s!r}")
            if idx is None:
                raise _bad(f"unknown validator {s!r}")
            out.append(idx)
        else:
            try:
                idx = int(s)
            except ValueError:
                raise _bad(f"invalid validator id {s!r}")
            if not (0 <= idx < len(state.validators)):
                raise _bad(f"unknown validator index {idx}")
            out.append(idx)
    return out


@route("POST", "/eth/v1/beacon/rewards/attestations/{epoch}", P1, cache=CKPT)
def rewards_attestations(ctx):
    """Attestation rewards for ``epoch`` (reference attestation_rewards.rs):
    computed on a state in epoch+1, whose previous-epoch participation IS
    epoch's."""
    from ..chain import rewards as rewards_mod

    chain = ctx.chain
    epoch = int(ctx.params["epoch"])
    spe = chain.spec.slots_per_epoch
    # Rewards for E need previous-epoch participation of E INCLUDING late
    # inclusions, i.e. the state at the END of epoch E+1 (reference
    # attestation_rewards.rs); resolve_state serves historical slots too.
    target_slot = min((epoch + 2) * spe - 1,
                      max(int(chain.head_state.slot), (epoch + 1) * spe))
    state, _ = ctx.resolve_state(str(target_slot))
    ids = _validator_indices(state, ctx.body)
    try:
        data = rewards_mod.attestation_rewards(state, chain.spec, ids)
    except ValueError as e:
        raise _bad(str(e))
    return {"execution_optimistic": False, "finalized": False, "data": data}


@route("GET", "/eth/v1/beacon/rewards/blocks/{block_id}", P1, cache=CKPT)
def rewards_blocks(ctx):
    from ..chain import rewards as rewards_mod

    root = ctx.resolve_block_root(ctx.params["block_id"])
    data = rewards_mod.block_rewards(ctx.chain, root)
    if data is None:
        raise _not_found("block or its states unavailable")
    return {"execution_optimistic": False, "finalized": False, "data": data}


@route("POST", "/eth/v1/beacon/rewards/sync_committee/{block_id}", P1, cache=CKPT)
def rewards_sync_committee(ctx):
    from ..chain import rewards as rewards_mod
    from ..consensus.per_slot import process_slots

    chain = ctx.chain
    root = ctx.resolve_block_root(ctx.params["block_id"])
    block = chain.get_block(root)
    if block is None:
        raise _not_found("unknown block")
    pre = chain.get_state(bytes(block.message.parent_root))
    if pre is None:
        raise _not_found("parent state unavailable")
    pre = pre.copy()
    if int(pre.slot) < int(block.message.slot):
        pre = process_slots(pre, int(block.message.slot), chain.types, chain.spec)
    ids = _validator_indices(pre, ctx.body)
    data = rewards_mod.sync_committee_rewards(pre, block, chain.spec, ids)
    return {"execution_optimistic": False, "finalized": False, "data": data}


@route("POST", "/lighthouse/ui/validator_monitor", P1)
def validator_monitor_register(ctx):
    """Register validator indices with the monitor (reference:
    --validator-monitor flags + the lighthouse UI endpoints)."""
    chain = ctx.chain
    epoch = chain.current_slot() // chain.spec.slots_per_epoch
    chain.validator_monitor.register(
        (int(i) for i in (ctx.body or [])), current_epoch=epoch
    )
    return None


@route("POST", "/lighthouse/ui/validator_metrics", P1)
def validator_metrics(ctx):
    """Cumulative hit/miss metrics for monitored validators (reference
    http_api/src/ui.rs:176 post_validator_monitor_metrics)."""
    body = ctx.body or {}
    indices = [int(i) for i in body.get("indices", [])]
    return {"data": ctx.chain.validator_monitor.validator_metrics(indices)}


@route("GET", "/lighthouse/ui/validator_monitor/{epoch}", P1)
def validator_monitor_summary(ctx):
    return {"data": ctx.chain.validator_monitor.summary(int(ctx.params["epoch"]))}


@route("GET", "/eth/v1/beacon/light_client/bootstrap/{block_root}")
def lc_bootstrap(ctx):
    root = bytes.fromhex(ctx.params["block_root"][2:])
    bootstrap = ctx.chain.produce_light_client_bootstrap(root)
    if bootstrap is None:
        raise _not_found("no light-client bootstrap for that root")
    return {"version": "altair", "data": to_json(bootstrap)}


@route("GET", "/eth/v1/beacon/light_client/updates")
def lc_updates(ctx):
    start = ctx.q1("start_period")
    count = ctx.q1("count")
    if start is None or count is None:
        raise _bad("start_period and count are required")
    updates = ctx.chain.lc_cache.get_updates(int(start), int(count))
    return [{"version": "altair", "data": to_json(u)} for u in updates]


@route("GET", "/eth/v1/beacon/light_client/finality_update")
def lc_finality_update(ctx):
    u = ctx.chain.lc_cache.latest_finality_update
    if u is None:
        raise _not_found("no finality update available")
    return {"version": "altair", "data": to_json(u)}


@route("GET", "/eth/v1/beacon/light_client/optimistic_update")
def lc_optimistic_update(ctx):
    u = ctx.chain.lc_cache.latest_optimistic_update
    if u is None:
        raise _not_found("no optimistic update available")
    return {"version": "altair", "data": to_json(u)}


@route("GET", "/eth/v1/config/spec")
def config_spec(ctx):
    spec = ctx.chain.spec
    preset = spec.preset
    out = {}
    for obj in (spec, preset):
        for k, v in vars(obj).items():
            if isinstance(v, bool) or k in ("preset", "config_name", "name"):
                continue
            if isinstance(v, int):
                out[k.upper()] = str(v)
            elif isinstance(v, bytes):
                out[k.upper()] = "0x" + v.hex()
    out["PRESET_BASE"] = preset.name
    out["CONFIG_NAME"] = spec.config_name
    out["SECONDS_PER_SLOT"] = str(spec.seconds_per_slot)
    return {"data": out}


@route("GET", "/eth/v1/config/fork_schedule")
def config_fork_schedule(ctx):
    spec = ctx.chain.spec
    sched = []
    prev = spec.genesis_fork_version
    forks = [
        ("phase0", spec.genesis_fork_version, 0),
        ("altair", spec.altair_fork_version, spec.altair_fork_epoch),
        ("bellatrix", spec.bellatrix_fork_version, spec.bellatrix_fork_epoch),
        ("capella", spec.capella_fork_version, spec.capella_fork_epoch),
        ("deneb", spec.deneb_fork_version, spec.deneb_fork_epoch),
        ("electra", spec.electra_fork_version, getattr(spec, "electra_fork_epoch", None)),
    ]
    for _, version, epoch in forks:
        if epoch is None:
            continue
        sched.append({
            "previous_version": "0x" + prev.hex(),
            "current_version": "0x" + version.hex(),
            "epoch": str(epoch),
        })
        prev = version
    return {"data": sched}


@route("GET", "/eth/v1/config/deposit_contract")
def config_deposit_contract(ctx):
    spec = ctx.chain.spec
    return {"data": {
        "chain_id": str(getattr(spec, "deposit_chain_id", 1)),
        "address": "0x" + "00" * 20,
    }}


# ------------------------------------------------------------- debug routes


@route("GET", "/eth/v2/debug/beacon/states/{state_id}")
def debug_state(ctx):
    state, _ = ctx.resolve_state(ctx.params["state_id"])
    fork = type(state).fork_name
    if ctx.wants_ssz:
        return SszResponse(state.as_ssz_bytes(), fork)
    return {
        "version": fork,
        "execution_optimistic": False,
        "finalized": False,
        "data": to_json(state),
    }


def _head_entries(ctx, with_optimistic: bool):
    chain = ctx.chain
    proto = chain.fork_choice.proto
    heads = []
    with chain.fork_choice.locked():  # prune() rebuilds the node array
        for root in proto.head_roots() if hasattr(proto, "head_roots") else [chain.head_root]:
            entry = {"root": "0x" + root.hex(), "slot": str(chain._blocks_slot(root))}
            if with_optimistic:
                entry["execution_optimistic"] = False
            heads.append(entry)
    return heads


@route("GET", "/eth/v1/debug/beacon/heads", cache=CKPT_BLOCKS)
def debug_heads(ctx):
    return {"data": _head_entries(ctx, with_optimistic=False)}


@route("GET", "/eth/v2/debug/beacon/heads", cache=CKPT_BLOCKS)
def debug_heads_v2(ctx):
    """v2 adds per-head execution_optimistic (reference get_debug_beacon_heads
    accepts any endpoint version via its any_version filter)."""
    return {"data": _head_entries(ctx, with_optimistic=True)}


@route("GET", "/eth/v1/debug/beacon/states/{state_id}")
def debug_state_v1(ctx):
    """v1 debug state: bare {data}, no version envelope (reference
    get_debug_beacon_states is version-generic; V1 responses are
    unversioned)."""
    state, _ = ctx.resolve_state(ctx.params["state_id"])
    fork = type(state).fork_name
    if ctx.wants_ssz:
        return SszResponse(state.as_ssz_bytes(), fork)
    return {"data": to_json(state)}


@route("GET", "/eth/v1/debug/fork_choice")
def debug_fork_choice(ctx):
    chain = ctx.chain
    proto = chain.fork_choice.proto
    nodes = []
    with chain.fork_choice.locked():  # prune() rebuilds the node array
        for node in proto.nodes_snapshot() if hasattr(proto, "nodes_snapshot") else []:
            nodes.append(node)
    j_epoch, j_root = chain.justified_checkpoint()
    f_epoch, f_root = chain.finalized_checkpoint()
    return {
        "justified_checkpoint": {"epoch": str(j_epoch), "root": "0x" + j_root.hex()},
        "finalized_checkpoint": {"epoch": str(f_epoch), "root": "0x" + f_root.hex()},
        "fork_choice_nodes": nodes,
    }


# ---------------------------------------------- standard-API completion
# The rest of the reference's beacon_node/http_api/src/lib.rs routes.


@route("GET", "/eth/v1/beacon/blinded_blocks/{block_id}", cache=CKPT)
def beacon_blinded_block(ctx):
    """The stored block served in blinded form (payload summarized to its
    header) — identical hash_tree_root by construction.  Reads the store's
    blinded representation directly when present: no EL round trip, and a
    payload the EL has since pruned cannot fail this endpoint."""
    root = ctx.resolve_block_root(ctx.params["block_id"])
    signed = ctx.chain.get_blinded_block(root)
    if signed is None:
        raise _not_found(f"block {ctx.params['block_id']}")
    fork = type(signed.message).fork_name
    return {"version": fork, "execution_optimistic": False,
            "finalized": False, "data": to_json(signed)}


@route("GET", "/eth/v1/beacon/deposit_snapshot")
def beacon_deposit_snapshot(ctx):
    """EIP-4881 deposit-tree snapshot from the eth1 follower (empty when no
    eth1 service is wired)."""
    svc = ctx.chain.eth1_service
    if svc is None or len(svc.deposit_cache) == 0:
        raise ApiError(404, "no deposit snapshot available")
    cache = svc.deposit_cache
    count = len(cache)
    return {"data": {
        "finalized": [],
        "deposit_root": "0x" + cache.deposit_root(count).hex(),
        "deposit_count": str(count),
        "execution_block_hash": "0x" + (
            svc.block_cache[-1]["hash"] if svc.block_cache else "00" * 32
        ).replace("0x", ""),
        "execution_block_height": str(
            svc.block_cache[-1]["number"] if svc.block_cache else 0),
    }}


@route("GET", "/eth/v1/beacon/pool/bls_to_execution_changes")
def pool_bls_changes_get(ctx):
    changes = list(ctx.chain.op_pool._bls_changes.values())
    return {"data": [to_json(c) for c in changes]}


@route("GET", "/eth/v1/builder/states/{state_id}/expected_withdrawals", cache=CKPT)
def expected_withdrawals(ctx):
    """The withdrawals the next payload built on this state must contain."""
    state, _ = ctx.resolve_state(ctx.params["state_id"])
    if not hasattr(state, "next_withdrawal_index"):
        raise _bad("state is pre-capella: withdrawals do not exist yet")
    if type(state).fork_name == "electra":
        expected, _ = h.get_expected_withdrawals_electra(
            state, ctx.chain.types, ctx.chain.spec)
    else:
        expected = h.get_expected_withdrawals(state, ctx.chain.types, ctx.chain.spec)
    return {"execution_optimistic": False, "finalized": False,
            "data": [to_json(w) for w in expected]}


@route("GET", "/eth/v2/validator/blocks/{slot}", P0)
def produce_block_v2(ctx):
    """v2 production: always a FULL block (the pre-v3 contract)."""
    chain = ctx.chain
    slot = int(ctx.params["slot"])
    reveal = ctx.q1("randao_reveal")
    if reveal is None:
        raise _bad("randao_reveal is required")
    graffiti = ctx.q1("graffiti")
    kwargs = {}
    if graffiti:
        kwargs["graffiti"] = bytes.fromhex(graffiti[2:]).ljust(32, b"\x00")
    block, _ = chain.produce_block(slot, bytes.fromhex(reveal[2:]), **kwargs)
    return {"version": type(block).fork_name, "data": to_json(block)}


@route("POST", "/eth/v1/beacon/states/{state_id}/validator_balances", cache=CKPT)
def state_validator_balances_post(ctx):
    """POST variant: ids in the body (the GET query-string variant caps out
    on URL length for big id sets)."""
    ctx.query = dict(ctx.query)
    body = ctx.body or {}
    ids = body.get("ids") if isinstance(body, dict) else body
    if ids:
        ctx.query["id"] = [str(x) for x in ids]
    return state_balances(ctx)


@route("GET", "/eth/v1/node/peers/{peer_id}")
def node_peer_by_id(ctx):
    pm = getattr(ctx.server, "peer_manager", None)
    if pm is not None:
        for pid, info in pm.peers().items():
            if str(pid) == ctx.params["peer_id"]:
                return {"data": {
                    "peer_id": str(pid),
                    "enr": "",
                    "last_seen_p2p_address": "",
                    "state": "connected" if info.connected else "disconnected",
                    "direction": "outbound",
                }}
    raise ApiError(404, "peer not found")


# ---------------------------------------------- lighthouse extension routes
# Reference http_api lighthouse/* surface (operator/UI endpoints).


@route("GET", "/lighthouse/health")
def lighthouse_health(ctx):
    """Process + machine health (reference common/system_health observation
    surfaced by the /lighthouse/health endpoint)."""
    import os as _os

    from ..system_health import observe_all

    data = observe_all()
    la = _os.getloadavg() if hasattr(_os, "getloadavg") else (0.0, 0.0, 0.0)
    data["sys_loadavg_1"], data["sys_loadavg_5"], data["sys_loadavg_15"] = la
    return {"data": data}


@route("GET", "/lighthouse/ui/health")
def lighthouse_ui_health(ctx):
    data = lighthouse_health(ctx)["data"]
    data["network_name"] = getattr(ctx.server, "network_name", "custom")
    return {"data": data}


@route("GET", "/lighthouse/ui/validator_count")
def lighthouse_validator_count(ctx):
    state = ctx.chain.head_state
    epoch = h.get_current_epoch(state, ctx.chain.spec)
    counts = {"active_ongoing": 0, "active_exiting": 0, "active_slashed": 0,
              "pending_initialized": 0, "pending_queued": 0,
              "withdrawal_possible": 0, "withdrawal_done": 0,
              "exited_unslashed": 0, "exited_slashed": 0}
    from ..types.spec import FAR_FUTURE_EPOCH as far
    for v in state.validators:
        if v.activation_epoch <= epoch < v.exit_epoch:
            if v.slashed:
                counts["active_slashed"] += 1
            elif v.exit_epoch != far:
                counts["active_exiting"] += 1
            else:
                counts["active_ongoing"] += 1
        elif epoch < v.activation_epoch:
            counts["pending_queued" if v.activation_eligibility_epoch != far
                   else "pending_initialized"] += 1
        elif epoch >= v.withdrawable_epoch:
            counts["withdrawal_possible"] += 1
        else:
            counts["exited_slashed" if v.slashed else "exited_unslashed"] += 1
    return {"data": counts}


@route("GET", "/lighthouse/syncing")
def lighthouse_syncing(ctx):
    data = node_syncing(ctx)["data"]
    return {"data": "Synced" if not data["is_syncing"] else {
        "SyncingFinalized": {"start_slot": "0",
                             "target_slot": data["head_slot"]}}}


@route("GET", "/lighthouse/peers")
def lighthouse_peers(ctx):
    return node_peers(ctx)


@route("GET", "/lighthouse/peers/connected")
def lighthouse_peers_connected(ctx):
    full = node_peers(ctx)
    data = [p for p in full["data"] if p["state"] == "connected"]
    return {"data": data, "meta": {"count": len(data)}}


@route("GET", "/lighthouse/proto_array")
def lighthouse_proto_array(ctx):
    proto = ctx.chain.fork_choice.proto
    nodes = []
    with ctx.chain.fork_choice.locked():  # prune() rebuilds the node array
        for i, n in enumerate(proto.nodes):
            nodes.append({
                "slot": str(n.slot),
                "root": "0x" + n.root.hex(),
                "parent": n.parent,
                "weight": str(n.weight),
                "best_child": n.best_child,
                "best_descendant": n.best_descendant,
                "execution_status": n.execution_status,
            })
    return {"data": {
        "justified_checkpoint": {
            "epoch": str(proto.justified_checkpoint[0]),
            "root": "0x" + proto.justified_checkpoint[1].hex(),
        },
        "finalized_checkpoint": {
            "epoch": str(proto.finalized_checkpoint[0]),
            "root": "0x" + proto.finalized_checkpoint[1].hex(),
        },
        "nodes": nodes,
    }}


@route("GET", "/lighthouse/database/info")
def lighthouse_database_info(ctx):
    db = ctx.chain.db
    return {"data": {
        "schema_version": db.schema_version()
        if hasattr(db, "schema_version") else 0,
        "config": {
            "slots_per_restore_point": getattr(db, "slots_per_restore_point", 0),
        },
        "split": {"slot": str(getattr(ctx.chain, "_migrated_slot", 0))},
        "anchor": {"anchor_slot": str(ctx.chain.anchor_slot)},
    }}


@route("POST", "/lighthouse/database/reconstruct")
def lighthouse_database_reconstruct(ctx):
    """Kick historic-state reconstruction (checkpoint-synced nodes): replay
    from the anchor forward.  Synchronous here — the in-process store
    reconstructs via the backfill path."""
    n = 0
    if hasattr(ctx.chain, "reconstruct_historic_states"):
        n = ctx.chain.reconstruct_historic_states()
    return {"data": f"started reconstruction ({n} states)"}


@route("GET", "/lighthouse/eth1/syncing")
def lighthouse_eth1_syncing(ctx):
    svc = ctx.chain.eth1_service
    if svc is None:
        raise ApiError(404, "eth1 service not enabled")
    head = svc.block_cache[-1] if svc.block_cache else None
    return {"data": {
        "head_block_number": head["number"] if head else 0,
        "head_block_timestamp": head.get("timestamp", 0) if head else 0,
        "latest_cached_block_number": head["number"] if head else 0,
        "latest_cached_block_timestamp": head.get("timestamp", 0) if head else 0,
        "voting_target_timestamp": 0,
        "eth1_node_sync_status_percentage": 100.0,
        "lighthouse_is_cached_and_ready": head is not None,
    }}


@route("GET", "/lighthouse/eth1/block_cache")
def lighthouse_eth1_blocks(ctx):
    svc = ctx.chain.eth1_service
    if svc is None:
        raise ApiError(404, "eth1 service not enabled")
    return {"data": svc.block_cache}


@route("GET", "/lighthouse/eth1/deposit_cache")
def lighthouse_eth1_deposits(ctx):
    svc = ctx.chain.eth1_service
    if svc is None:
        raise ApiError(404, "eth1 service not enabled")
    return {"data": [to_json(d) for d in svc.deposit_cache._deposit_data]}


@route("GET", "/lighthouse/nat")
def lighthouse_nat(ctx):
    return {"data": True}  # own-fabric transport: no NAT discovery problem


@route("GET", "/lighthouse/staking")
def lighthouse_staking(ctx):
    # reference: 200 iff the node was started with staking flags (eth1 /
    # payload production able); our chain always has an execution engine
    return {"data": ctx.chain.execution_engine is not None}


@route("GET", "/lighthouse/merge_readiness")
def lighthouse_merge_readiness(ctx):
    state = ctx.chain.head_state
    merged = hasattr(state, "latest_execution_payload_header") and any(
        bytes(state.latest_execution_payload_header.block_hash)
    )
    return {"data": {"type": "ready", "config": {"post_merge": merged}}}


def _inclusion_state(ctx, epoch: int):
    """The state whose ``current_epoch_participation`` register belongs to
    the requested epoch (reference validator_inclusion loads the state at
    the requested epoch, so 'current'/'previous' fields each come from
    their own register)."""
    chain = ctx.chain
    state = chain.head_state
    current_epoch = h.get_current_epoch(state, chain.spec)
    if epoch not in (current_epoch, max(0, current_epoch - 1)):
        raise _bad(f"epoch {epoch} is not the current or previous epoch")
    if epoch != current_epoch:
        # Rewind to the requested epoch's end: replay from the ANCESTOR block
        # at/before that slot (state_at_slot cannot rewind the head state).
        end_slot = (epoch + 1) * chain.spec.slots_per_epoch - 1
        ancestor = h.get_block_root_at_slot(state, end_slot, chain.spec)
        state, _ = chain.state_at_slot(end_slot, bytes(ancestor))
    return state


def _inclusion_data(ctx, epoch: int):
    """Per-epoch participation totals from the flag registry (the
    reference's validator_inclusion computed from participation caches) —
    current-epoch fields from ``current_epoch_participation``,
    previous-epoch fields from ``previous_epoch_participation``."""
    from ..types.spec import TIMELY_HEAD_FLAG_INDEX, TIMELY_TARGET_FLAG_INDEX

    state = _inclusion_state(ctx, epoch)
    prev_epoch = max(0, epoch - 1)
    cur_part = state.current_epoch_participation
    prev_part = state.previous_epoch_participation
    cur_active = 0
    cur_target = prev_target = prev_head = 0
    for i, v in enumerate(state.validators):
        eb = int(v.effective_balance)
        if v.activation_epoch <= epoch < v.exit_epoch:
            cur_active += eb
            flags = int(cur_part[i]) if i < len(cur_part) else 0
            if flags & (1 << TIMELY_TARGET_FLAG_INDEX) and not v.slashed:
                cur_target += eb
        if v.activation_epoch <= prev_epoch < v.exit_epoch:
            flags = int(prev_part[i]) if i < len(prev_part) else 0
            if not v.slashed:
                if flags & (1 << TIMELY_TARGET_FLAG_INDEX):
                    prev_target += eb
                if flags & (1 << TIMELY_HEAD_FLAG_INDEX):
                    prev_head += eb
    # Exactly the reference GlobalValidatorInclusionData fields
    # (common/eth2/src/lighthouse.rs:54-66) — no extra keys.
    return {
        "current_epoch_active_gwei": str(cur_active),
        "current_epoch_target_attesting_gwei": str(cur_target),
        "previous_epoch_target_attesting_gwei": str(prev_target),
        "previous_epoch_head_attesting_gwei": str(prev_head),
    }


@route("GET", "/lighthouse/validator_inclusion/{epoch}/global")
def lighthouse_inclusion_global(ctx):
    return {"data": _inclusion_data(ctx, int(ctx.params["epoch"]))}


@route("GET", "/lighthouse/validator_inclusion/{epoch}/{validator_id}")
def lighthouse_inclusion_validator(ctx):
    from ..types.spec import (
        TIMELY_HEAD_FLAG_INDEX,
        TIMELY_SOURCE_FLAG_INDEX,
        TIMELY_TARGET_FLAG_INDEX,
    )

    chain = ctx.chain
    epoch = int(ctx.params["epoch"])
    state = _inclusion_state(ctx, epoch)
    prev_epoch = max(0, epoch - 1)
    vid = ctx.params["validator_id"]
    idx = int(vid) if not vid.startswith("0x") else next(
        (i for i, v in enumerate(state.validators)
         if bytes(v.pubkey).hex() == vid[2:]), -1)
    if not (0 <= idx < len(state.validators)):
        raise ApiError(404, "validator not found")
    v = state.validators[idx]
    cur_part = state.current_epoch_participation
    prev_part = state.previous_epoch_participation
    cur_flags = int(cur_part[idx]) if idx < len(cur_part) else 0
    prev_flags = int(prev_part[idx]) if idx < len(prev_part) else 0
    # Attester booleans follow the reference ParticipationCache's
    # is_unslashed_participating_index: flag AND active-in-epoch AND
    # not slashed (a slashed validator's stale flags must not read true).
    unslashed_cur = (v.activation_epoch <= epoch < v.exit_epoch) and not v.slashed
    unslashed_prev = (
        v.activation_epoch <= prev_epoch < v.exit_epoch
    ) and not v.slashed
    return {"data": {
        "is_slashed": bool(v.slashed),
        "is_withdrawable_in_current_epoch": epoch >= int(v.withdrawable_epoch),
        "is_active_unslashed_in_current_epoch": unslashed_cur,
        "is_active_unslashed_in_previous_epoch": unslashed_prev,
        "current_epoch_effective_balance_gwei": str(int(v.effective_balance)),
        "is_current_epoch_target_attester":
            unslashed_cur and bool(cur_flags & (1 << TIMELY_TARGET_FLAG_INDEX)),
        "is_previous_epoch_target_attester":
            unslashed_prev and bool(prev_flags & (1 << TIMELY_TARGET_FLAG_INDEX)),
        "is_previous_epoch_head_attester":
            unslashed_prev and bool(prev_flags & (1 << TIMELY_HEAD_FLAG_INDEX)),
        "is_previous_epoch_source_attester":
            unslashed_prev and bool(prev_flags & (1 << TIMELY_SOURCE_FLAG_INDEX)),
    }}


@route("POST", "/lighthouse/liveness")
def lighthouse_liveness(ctx):
    """Like the standard liveness route but takes {indices, epoch} in one
    body (the VC's preferred bulk shape)."""
    body = ctx.body or {}
    epoch = int(body.get("epoch", 0))
    chain = ctx.chain
    out = []
    for raw in body.get("indices", []):
        idx = int(raw)
        out.append({
            "index": str(idx),
            "epoch": str(epoch),
            "is_live": bool(chain.observed.validator_seen_at_epoch(
                epoch, idx, chain.spec.slots_per_epoch)),
        })
    return {"data": out}


def _block_rewards_range(ctx, start_slot: int, end_slot: int):
    from ..chain.rewards import block_rewards as _block_rewards

    chain = ctx.chain
    out = []
    root = chain.head_root
    # walk the canonical chain backwards through the requested window
    while root is not None and root != chain.genesis_block_root:
        slot = chain._blocks_slot(root)
        if slot < start_slot:
            break
        if slot <= end_slot:
            r = _block_rewards(chain, root)
            if r is not None:
                # analysis-layer enrichment (watch keys rows by slot); the
                # standard /eth/v1/beacon/rewards/blocks response keeps the
                # bare spec shape.
                r = dict(r, slot=str(slot), block_root="0x" + root.hex())
                out.append(r)
        blk = chain.get_block(root)
        if blk is None:
            break
        root = bytes(blk.message.parent_root)
    out.reverse()
    return out


@route("GET", "/lighthouse/analysis/block_rewards")
def lighthouse_block_rewards(ctx):
    start = int(ctx.q1("start_slot", "1"))
    end = int(ctx.q1("end_slot", str(ctx.chain.current_slot())))
    return {"data": _block_rewards_range(ctx, start, end)}


@route("POST", "/lighthouse/analysis/block_rewards")
def lighthouse_block_rewards_post(ctx):
    body = ctx.body or {}
    return {"data": _block_rewards_range(
        ctx, int(body.get("start_slot", 1)),
        int(body.get("end_slot", ctx.chain.current_slot())))}


@route("GET", "/lighthouse/analysis/attestation_performance/{index}")
def lighthouse_attestation_performance(ctx):
    """Per-validator inclusion record over an epoch range, from the
    validator monitor + participation flags."""
    from ..types.spec import TIMELY_TARGET_FLAG_INDEX

    chain = ctx.chain
    state = chain.head_state
    idx = int(ctx.params["index"])
    if idx >= len(state.validators):
        raise ApiError(404, "validator not found")
    current_epoch = h.get_current_epoch(state, chain.spec)
    start = int(ctx.q1("start_epoch", str(max(0, current_epoch - 1))))
    end = int(ctx.q1("end_epoch", str(current_epoch)))
    out = []
    for epoch in range(start, end + 1):
        if epoch == current_epoch:
            part = state.current_epoch_participation
        elif epoch == current_epoch - 1:
            part = state.previous_epoch_participation
        else:
            continue  # only the live window is cheaply answerable
        flags = int(part[idx]) if idx < len(part) else 0
        out.append({
            "epoch": str(epoch),
            "active": bool(
                state.validators[idx].activation_epoch <= epoch
                < state.validators[idx].exit_epoch),
            "attested": bool(flags & (1 << TIMELY_TARGET_FLAG_INDEX)),
        })
    return {"data": [{"index": str(idx), "epochs": out}]}


@route("GET", "/lighthouse/analysis/block_packing_efficiency")
def lighthouse_block_packing(ctx):
    """Attestation-packing efficiency over a slot window: included unique
    attester bits vs available (reference block_packing_efficiency.rs)."""
    chain = ctx.chain
    start = int(ctx.q1("start_epoch", "0"))
    end = int(ctx.q1("end_epoch", str(
        chain.current_slot() // chain.spec.slots_per_epoch)))
    spe = chain.spec.slots_per_epoch
    out = []
    root = chain.head_root
    while root is not None and root != chain.genesis_block_root:
        slot = chain._blocks_slot(root)
        if slot < start * spe:
            break
        blk = chain.get_block(root)
        if blk is None:
            break
        if slot < (end + 1) * spe:
            atts = list(blk.message.body.attestations)
            included = sum(
                sum(1 for b in a.aggregation_bits if b) for a in atts
            )
            out.append({
                "slot": str(slot),
                "block_hash": "0x" + root.hex(),
                "available_attestations": included,  # naive-pool upper bound
                "included_attestations": included,
                "prior_skip_slots": 0,
            })
        root = bytes(blk.message.parent_root)
    out.reverse()
    return {"data": out}


@route("POST", "/lighthouse/ui/validator_info")
def lighthouse_ui_validator_info(ctx):
    body = ctx.body or {}
    state = ctx.chain.head_state
    info = {}
    for raw in body.get("indices", []):
        idx = int(raw)
        if 0 <= idx < len(state.validators):
            v = state.validators[idx]
            info[str(idx)] = {
                "info": {
                    "activation_epoch": str(int(v.activation_epoch)),
                    "balance": str(int(state.balances[idx])),
                    "effective_balance": str(int(v.effective_balance)),
                    "slashed": bool(v.slashed),
                    "withdrawal_credentials":
                        "0x" + bytes(v.withdrawal_credentials).hex(),
                },
            }
    return {"data": {"validators": info}}


# ------------------------------------------------------------ traces routes
# The span-tracing surface (tracing.py): per-event span trees for the
# block-import → device-batch pipeline, the per-trace complement of the
# aggregate /metrics histograms.


@route("GET", "/lighthouse/traces", P1)
def lighthouse_traces(ctx):
    """Recent completed-trace summaries, newest first.  Query params:
    ``root`` (root-span name, e.g. ``block_import`` or ``work:gossip_block``),
    ``slot`` (root's slot field), ``limit``."""
    slot = ctx.q1("slot")
    try:
        limit = int(ctx.q1("limit", "64"))
    except ValueError:
        raise _bad("limit must be an integer")
    traces = tracing.TRACES.recent(
        limit=max(1, min(limit, 512)),
        root=ctx.q1("root"),
        slot=None if slot is None else int(slot),
    )
    return {"data": [tracing.trace_summary(t) for t in traces]}


@route("GET", "/lighthouse/traces/{trace_id}", P1)
def lighthouse_trace_by_id(ctx):
    """One full span tree; ``?format=chrome`` emits Chrome trace-event JSON
    loadable in Perfetto / chrome://tracing."""
    trace = tracing.TRACES.get(ctx.params["trace_id"])
    if trace is None:
        raise _not_found(f"trace {ctx.params['trace_id']}")
    if ctx.q1("format") == "chrome":
        return tracing.trace_to_chrome(trace)
    return {"data": tracing.trace_to_dict(trace)}


# ------------------------------------------------------------ device routes
# The device telemetry surface (device_telemetry.py): compile-cache
# inventory, padding-waste occupancy, the batch flight recorder, device
# memory, and the on-demand profiler — the "why was device_batch_wait
# slow" complement of the traces API.


@route("GET", "/lighthouse/device", P1)
def lighthouse_device(ctx):
    """Device telemetry summary: compiled-program inventory (op, bucket
    shape, compile seconds, invocation counts), occupancy percentiles over
    the flight-recorder window, host-fallback tallies, and per-device
    ``memory_stats()``."""
    from .. import device_telemetry

    return {"data": device_telemetry.summary()}


@route("GET", "/lighthouse/device/batches", P1)
def lighthouse_device_batches(ctx):
    """Recent device-batch flight-recorder records, newest first.  Query
    params: ``op`` (e.g. ``bls_verify``), ``trace_id`` (cross-reference
    from ``/lighthouse/traces/{id}``), ``node`` (records stamped by one
    node's telemetry scope), ``limit``."""
    from .. import device_telemetry

    try:
        limit = int(ctx.q1("limit", "64"))
    except ValueError:
        raise _bad("limit must be an integer")
    return {"data": device_telemetry.FLIGHT_RECORDER.recent(
        limit=max(1, min(limit, device_telemetry.FLIGHT_RECORDER.capacity)),
        op=ctx.q1("op"),
        trace_id=ctx.q1("trace_id"),
        node=ctx.q1("node"),
    )}


@route("POST", "/lighthouse/device/profile", P1)
def lighthouse_device_profile(ctx):
    """Capture ``?seconds=N`` (default 3, capped at 10 — the API task
    spawner allows 30 s per handler) of ``torch.profiler`` (CPU and CUDA
    activity) and return the dump directory and its Chrome trace for
    Perfetto.  501 without a card, 409 when a capture is already
    running."""
    from .. import device_telemetry

    try:
        seconds = float(ctx.q1("seconds", "3"))
    except ValueError:
        raise _bad("seconds must be a number")
    if seconds <= 0:
        raise _bad("seconds must be positive")
    try:
        return {"data": device_telemetry.capture_profile(seconds)}
    except device_telemetry.ProfilerUnavailable as e:
        raise ApiError(501, f"NOT_IMPLEMENTED: {e}")
    except device_telemetry.ProfilerBusy as e:
        raise ApiError(409, f"CONFLICT: {e}")


# ------------------------------------------------------------ faults routes
# The fault-injection admin surface (fault_injection.py): install, list,
# and clear deterministic fault plans against the named injection points —
# the chaos-testing companion of the device supervisor.


@route("GET", "/lighthouse/faults", P1)
def lighthouse_faults(ctx):
    """Active fault plans with hit/fired counts, plus the known points."""
    from .. import fault_injection

    return {"data": fault_injection.summary()}


@route("POST", "/lighthouse/faults", P1)
def lighthouse_faults_install(ctx):
    """Install fault plans.  Body: ``{"spec": "<plan;plan;...>"}`` (the
    env-var syntax, e.g. ``device.dispatch[op=bls_verify]=error``) or a
    single structured plan ``{"point": ..., "mode": ..., "op": ...,
    "first_n": ..., "probability": ..., "seed": ..., "sleep_s": ...}``."""
    from .. import fault_injection

    body = ctx.body or {}
    if not isinstance(body, dict):
        raise _bad("body must be a JSON object")
    try:
        if "spec" in body:
            plans = [
                fault_injection.REGISTRY.install(p)
                for p in fault_injection.parse_spec(body["spec"])
            ]
        elif "point" in body:
            kwargs = {
                k: body[k]
                for k in ("op", "first_n", "probability", "seed",
                          "sleep_s", "message")
                if body.get(k) is not None
            }
            plans = [fault_injection.install(
                body["point"], body.get("mode", "error"), **kwargs)]
        else:
            raise _bad("body needs a 'spec' string or a 'point' plan")
    except (TypeError, ValueError) as e:
        # TypeError: non-numeric probability/first_n/seed in a structured
        # plan — a client input error, not a server bug.
        raise _bad(str(e))
    return {"data": [p.to_dict() for p in plans]}


@route("DELETE", "/lighthouse/faults", P1)
def lighthouse_faults_clear(ctx):
    """Clear fault plans: all of them, ``?point=<point>``, or ``?id=<id>``."""
    from .. import fault_injection

    plan_id = ctx.q1("id")
    try:
        plan_id = None if plan_id is None else int(plan_id)
    except ValueError:
        raise _bad(f"id must be an integer, got {plan_id!r}")
    cleared = fault_injection.clear(point=ctx.q1("point"), plan_id=plan_id)
    return {"data": {"cleared": cleared}}


@route("GET", "/lighthouse/events/subscribers", P1)
def lighthouse_events_subscribers(ctx):
    """Per-subscriber SSE state: topics, queue depth, delivered and dropped
    event counts (the per-topic aggregates live on /metrics as
    ``http_sse_events_{sent,dropped}_total``)."""
    return {"data": ctx.chain.events.summary()}


@route("GET", "/lighthouse/autotune", P1)
def lighthouse_autotune(ctx):
    """The self-tuning control plane in one read (autotune.py): mode,
    static vs live bucket vocabularies, the decision log (every adoption /
    drop / refusal with its guardrail reason), warmup states, the measured
    walk-lookahead selection, and the admission layer's effective (latency-
    tracked) bounds next to its static configuration."""
    from .. import autotune

    data = autotune.snapshot()
    data["admission"] = ctx.server.spawner.admission.snapshot()
    return {"data": data}


@route("GET", "/lighthouse/serving", P1)
def lighthouse_serving(ctx):
    """The serving-performance surface in one read: response-cache
    occupancy/hit-rate, per-class admission state, and the device
    arbiter's grant table (is API work contending like pipeline work?)."""
    from .. import device_pipeline

    cache = ctx.server.response_cache
    return {"data": {
        "cache": cache.snapshot() if cache is not None else None,
        "admission": ctx.server.spawner.admission.snapshot(),
        "arbiter": device_pipeline.ARBITER.snapshot(),
        "cached_routes": {
            f"{m} {p}": list(t) for (m, p), t in sorted(CACHED_ROUTES.items())
        },
    }}


# ---------------------------------------------------------- blackbox routes
# The incident black box (blackbox.py): the causally-ordered journal that
# every seam feeds, and the frozen postmortem bundles it writes on breaker
# trips / watchdog timeouts / scenario gate failures.


@route("GET", "/lighthouse/postmortems", P1)
def lighthouse_postmortems(ctx):
    """The black-box summary: journal occupancy, capture index (reason,
    slot, journal/flight/trace counts per bundle), and the bundle files on
    disk, newest first.  ``?bundle=<filename>`` returns one full bundle."""
    from .. import blackbox

    name = ctx.q1("bundle")
    if name is not None:
        bundle = blackbox.load_bundle(name)
        if bundle is None:
            raise _not_found(f"bundle {name}")
        return {"data": bundle}
    return {"data": blackbox.summary()}


@route("GET", "/lighthouse/postmortems/journal", P1)
def lighthouse_postmortems_journal(ctx):
    """The live incident journal, oldest first.  Query params: ``source``
    (e.g. ``breaker``, ``device_batch``), ``limit``."""
    from .. import blackbox

    try:
        limit = int(ctx.q1("limit", "256"))
    except ValueError:
        raise _bad("limit must be an integer")
    return {"data": blackbox.JOURNAL.window(
        limit=max(1, min(limit, blackbox.JOURNAL.capacity)),
        source=ctx.q1("source"),
    )}


@route("GET", "/lighthouse/fleet", P1)
def lighthouse_fleet(ctx):
    """Fleet observability (telemetry_scope.py): per-node scope snapshots
    (Lamport clock, journal/tail occupancy, per-scope tallies) and the
    merged causally-ordered timeline over every registered node's journal
    — ordered on (virtual slot, Lamport clock, node id, per-node seq), so
    "which node broke the fleet" reads top-to-bottom.  Query params:
    ``limit`` (tail of the merged timeline)."""
    from .. import blackbox

    limit = ctx.q1("limit")
    if limit is not None:
        try:
            limit = max(1, int(limit))
        except ValueError:
            raise _bad("limit must be an integer")
    return {"data": blackbox.fleet_summary(limit=limit)}


@route("POST", "/lighthouse/postmortem", P1)
def lighthouse_postmortem_capture(ctx):
    """Freeze a postmortem bundle right now (the operator's "something is
    off, snapshot everything" button).  Body: ``{"reason": "..."}``
    (optional; defaults to ``manual``)."""
    from .. import blackbox

    body = ctx.body or {}
    if not isinstance(body, dict):
        raise _bad("body must be a JSON object")
    reason = body.get("reason") or "manual"
    if not isinstance(reason, str):
        raise _bad("reason must be a string")
    return {"data": blackbox.capture(f"manual:{reason}"
                                     if reason != "manual" else "manual")}


# ------------------------------------------------------------------ server


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = VERSION_STRING
    # Responses go out as (at least) two segments — buffered headers, then
    # body.  With Nagle on, the body write sits behind the peer's delayed
    # ACK: a measured ~40 ms floor per response on loopback, which would
    # bury the cache's sub-millisecond hits.
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # quiet
        pass

    @property
    def api(self) -> "HttpApiServer":
        return self.server.api_server  # type: ignore[attr-defined]

    def _write_json(self, code: int, payload,
                    headers: Optional[Dict[str, str]] = None) -> None:
        body = b"" if payload is None else json.dumps(payload).encode()
        self._write_json_bytes(code, body, headers)

    def _write_json_bytes(self, code: int, body: bytes,
                          headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        for hk, hv in (headers or {}).items():
            self.send_header(hk, hv)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _write_ssz(self, data: bytes, version: Optional[str],
                   headers: Dict[str, str]) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        if version:
            self.send_header("Eth-Consensus-Version", version)
        for hk, hv in headers.items():
            self.send_header(hk, hv)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _write_cached(self, entry: "CacheEntry") -> None:
        if entry.kind == "ssz":
            self._write_ssz(entry.body, entry.version, dict(entry.headers))
        else:
            self._write_json_bytes(200, entry.body)

    def _handle(self, method: str) -> None:
        parsed = urlparse(self.path)
        path = parsed.path
        # Resolve the route TEMPLATE first: the metrics label must be
        # bounded-cardinality (templates + the three streaming endpoints +
        # "unmatched"), never the raw client-controlled path.
        if path in ("/metrics", "/eth/v1/events", "/lighthouse/logs"):
            route, m = path, None
        else:
            m = match_route(method, path)
            route = m[3] if m is not None else "unmatched"
        metrics.HTTP_REQUESTS.inc(method=method, route=route)
        labels = {"method": method, "route": route}
        # One seam feeds both the request histogram and the trace ring.
        # Streaming endpoints, 404s, and the traces API itself (observing
        # the observer) are timed but not traced.  The root name carries the
        # route template so each route gets its OWN bounded sub-ring — a
        # health-check poller must not evict the rare block-publish trace.
        if m is not None and not route.startswith("/lighthouse/traces"):
            timer = tracing.span(
                f"http:{method} {route}", hist=metrics.HTTP_REQUEST_SECONDS,
                hist_labels=labels, **labels,
            )
        else:
            timer = metrics.HTTP_REQUEST_SECONDS.time(**labels)
        with timer:
            try:
                if path == "/metrics" and method == "GET":
                    body = metrics.render_prometheus().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/eth/v1/events" and method == "GET":
                    self._serve_events(parse_qs(parsed.query))
                    return
                if path == "/lighthouse/logs" and method == "GET":
                    self._serve_logs()
                    return
                # Drain the body before any response — an unread body on a
                # keep-alive connection corrupts the next request.
                body = None
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                if m is None:
                    self._write_json(404, {"code": 404, "message": f"NOT_FOUND: {path}"})
                    return
                priority, fn, params, _ = m
                if raw:
                    ctype = (self.headers.get("Content-Type") or "").lower()
                    if "application/octet-stream" in ctype:
                        if not getattr(fn, "_accepts_ssz", False):
                            self._write_json(415, {
                                "code": 415,
                                "message": "this route does not accept application/octet-stream",
                            })
                            return
                        body = raw  # SSZ upload: the handler decodes
                    else:
                        try:
                            body = json.loads(raw)
                        except json.JSONDecodeError:
                            self._write_json(400, {"code": 400, "message": "invalid JSON"})
                            return
                ctx = Context(self.api, params, parse_qs(parsed.query), body, self.headers)
                # Checkpoint-keyed response cache (response_cache.py): a hit
                # replays stored bytes from the HTTP thread — no admission,
                # no scheduler queue, no handler.
                cache = self.api.response_cache
                topics = getattr(fn, "_cache_topics", None)
                ckey = None
                if cache is not None and topics:
                    ckey = cache.make_key(
                        method, route, params, ctx.query, body, ctx.wants_ssz)
                if ckey is not None:
                    hit = cache.get(ckey, route)
                    if hit is not None:
                        tracing.annotate(cache="hit")
                        self._write_cached(hit)
                        return
                    tracing.annotate(cache="miss")
                gen_box = {}
                if ckey is not None:
                    # Cache-miss state work must contend at the shared
                    # device arbiter like pipeline work does — one
                    # bounded-cardinality op label for the whole API
                    # surface.  The cache generation is read
                    # on the worker thread just before the handler runs:
                    # put() refuses the entry if any invalidation event
                    # fired during execution (mid-handler reorg guard).
                    def call(fn=fn, ctx=ctx, cache=cache, gen_box=gen_box):
                        gen_box["gen"] = cache.generation
                        with api_arbiter_slot("http_api"):
                            return fn(ctx)
                else:
                    def call(fn=fn, ctx=ctx):
                        return fn(ctx)
                try:
                    result = self.api.spawner.blocking_json_task(
                        priority, call, klass=getattr(fn, "_klass", None))
                    # Store BEFORE writing: the moment the response bytes
                    # reach the client it may fire the next request, which
                    # must hit.
                    if isinstance(result, SszResponse):
                        if ckey is not None:
                            cache.put(ckey, route, CacheEntry(
                                "ssz", result.data, result.version,
                                tuple(result.headers.items()), ckey[0], topics),
                                generation=gen_box.get("gen"))
                        self._write_ssz(result.data, result.version, result.headers)
                    else:
                        body_bytes = (b"" if result is None
                                      else json.dumps(result).encode())
                        if ckey is not None and result is not None:
                            cache.put(ckey, route, CacheEntry(
                                "json", body_bytes, None, (), ckey[0], topics),
                                generation=gen_box.get("gen"))
                        self._write_json_bytes(200, body_bytes)
                except ValueError as e:
                    # Malformed user-supplied ints/hex parse straight to
                    # ValueError — a contract 400.  Other exception types stay
                    # 500s so server bugs aren't masked as client errors.
                    self._write_json(400, {"code": 400, "message": f"BAD_REQUEST: {e}"})
                except ApiError as e:
                    if e.code in (200, 206):  # health-style status responses
                        self._write_json(e.code, None)
                    else:
                        try:
                            payload = json.loads(e.message)
                        except (json.JSONDecodeError, TypeError):
                            payload = {"code": e.code, "message": e.message}
                        self._write_json(e.code, payload)
                except ShedError as e:
                    # Admission shed: immediate 503 + Retry-After so a
                    # well-behaved client backs off instead of hammering.
                    tracing.annotate(shed=e.reason)
                    self._write_json(
                        503, {"code": 503, "message": str(e)},
                        headers={"Retry-After": str(e.retry_after_s)})
                except OverloadedError as e:
                    self._write_json(503, {"code": 503, "message": str(e)},
                                     headers={"Retry-After": "1"})
                except TimeoutError as e:
                    self._write_json(504, {"code": 504, "message": str(e)})
            except BrokenPipeError:
                pass
            except Exception as e:  # internal error — never kill the thread
                try:
                    self._write_json(500, {"code": 500, "message": f"{type(e).__name__}: {e}"})
                except Exception:
                    pass

    def _serve_events(self, query) -> None:
        topics = []
        for t in query.get("topics", []):
            topics.extend(t.split(","))
        if not topics:
            self._write_json(400, {"code": 400, "message": "topics required"})
            return
        try:
            sub = self.api.chain.events.subscribe(topics)
        except ValueError as e:
            self._write_json(400, {"code": 400, "message": str(e)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            while not self.api._shutdown.is_set():
                item = sub.poll(timeout=0.25)
                if item is None:
                    continue
                topic, data = item
                chunk = f"event: {topic}\ndata: {json.dumps(data)}\n\n".encode()
                self.wfile.write(chunk)
                self.wfile.flush()
                # Delivery accounting: the write succeeded (a broken pipe
                # raises before this line), so the event reached the client.
                sub.sent += 1
                metrics.SSE_EVENTS_SENT.inc(topic=topic)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            self.api.chain.events.unsubscribe(sub)

    def _serve_logs(self) -> None:
        """SSE tail of the structured log ring (the reference's
        ``lighthouse/logs`` Siren feed, common/logging SSE tap)."""
        from ..logs import RING

        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        last_seq = 0
        try:
            # replay the recent tail first, then follow
            for entry in RING.tail(64):
                last_seq = entry["seq"]
                self.wfile.write(
                    f"event: logs\ndata: {json.dumps(entry)}\n\n".encode())
            self.wfile.flush()
            while not self.api._shutdown.is_set():
                fresh = RING.wait_for(last_seq, timeout=0.25)
                for entry in fresh:
                    last_seq = entry["seq"]
                    self.wfile.write(
                        f"event: logs\ndata: {json.dumps(entry)}\n\n".encode())
                if fresh:
                    self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_DELETE(self):
        self._handle("DELETE")


class _ApiHTTPServer(ThreadingHTTPServer):
    """Thread-per-connection server with a listen backlog sized for load
    bursts: the stdlib default of 5 refuses connections the moment a
    thousand clients arrive in one RTT, which turns a load spike into
    connect errors before admission control ever sees the requests."""

    request_queue_size = 1024
    daemon_threads = True


class HttpApiServer:
    """Serve the beacon API for a chain over TCP.

    ``processor`` routes handlers through the scheduler (P0/P1); ``None``
    runs them inline.  ``publish_block_fn``/``publish_attestation_fn`` are
    called after successful local import to gossip the object out (wired by
    ``LocalNode``)."""

    def __init__(
        self,
        chain,
        *,
        processor=None,
        host: str = "127.0.0.1",
        port: int = 0,
        peer_id: str = "",
        peer_manager=None,
        publish_block_fn=None,
        publish_attestation_fn=None,
        response_cache: bool = True,
        admission: Optional[AdmissionController] = None,
    ):
        self.chain = chain
        self.spawner = TaskSpawner(processor, admission=admission)
        self.peer_id = peer_id
        self.peer_manager = peer_manager
        self.publish_block_fn = publish_block_fn
        self.publish_attestation_fn = publish_attestation_fn
        # Checkpoint-keyed response cache, invalidated by the chain's own
        # head/finalization events.  ``response_cache=False`` (or the env
        # kill switch) serves every request uncached — the baseline the
        # load harness and the api_load scenario compare against.
        import os as _os

        enabled = (response_cache
                   and _os.environ.get("LIGHTHOUSE_TPU_API_CACHE", "1") != "0")
        self.response_cache: Optional[ResponseCache] = (
            ResponseCache(chain) if enabled else None
        )
        if self.response_cache is not None:
            self.response_cache.attach(chain.events)
        self._httpd = _ApiHTTPServer((host, port), _Handler)
        self._httpd.api_server = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._shutdown = threading.Event()
        # Postmortem bundles get the serving admission state alongside the
        # built-in breaker/mesh/pipeline snapshots (last server wins when
        # tests run several; stop() withdraws ours).
        from .. import blackbox

        blackbox.register_snapshot("admission", self.spawner.admission.snapshot)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "HttpApiServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-api", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._shutdown.set()
        from .. import blackbox

        blackbox.unregister_snapshot("admission")
        if self.response_cache is not None:
            self.response_cache.detach()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
