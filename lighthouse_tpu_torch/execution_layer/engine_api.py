"""Typed engine-API JSON-RPC client.

Equivalent of the reference's ``execution_layer/src/engine_api/http.rs``
(``HttpJsonRpc`` — newPayload/forkchoiceUpdated/getPayload V1-V3, capability
exchange), with the payload JSON (de)serialization the engine spec defines:
camelCase keys, 0x-hex QUANTITY/DATA encodings.

A copy of the JAX package's ``lighthouse_tpu/execution_layer/engine_api.py``;
the client names itself with the port's version in ``engine_getClientVersionV1``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from . import auth

STATUS_VALID = "VALID"
STATUS_INVALID = "INVALID"
STATUS_SYNCING = "SYNCING"
STATUS_ACCEPTED = "ACCEPTED"
STATUS_INVALID_BLOCK_HASH = "INVALID_BLOCK_HASH"

SUPPORTED_METHODS = [
    "engine_exchangeCapabilities",
    "engine_newPayloadV1",
    "engine_newPayloadV2",
    "engine_newPayloadV3",
    "engine_newPayloadV4",
    "engine_forkchoiceUpdatedV1",
    "engine_forkchoiceUpdatedV2",
    "engine_forkchoiceUpdatedV3",
    "engine_getPayloadV1",
    "engine_getPayloadV2",
    "engine_getPayloadV3",
    "engine_getPayloadV4",
    "engine_getPayloadBodiesByHashV1",
    "engine_getPayloadBodiesByRangeV1",
    "engine_getClientVersionV1",
]


class EngineApiError(Exception):
    def __init__(self, message: str, code: Optional[int] = None):
        super().__init__(message)
        self.code = code


class EngineOffline(EngineApiError):
    pass


# --------------------------------------------------------- payload serde


def _q(v: int) -> str:  # QUANTITY
    return hex(int(v))


def _d(b: bytes) -> str:  # DATA
    return "0x" + bytes(b).hex()


def withdrawal_to_json(w) -> Dict[str, str]:
    """Engine-API WithdrawalV1 encoding — shared by payload serde and
    PayloadAttributes construction."""
    return {
        "index": _q(w.index),
        "validatorIndex": _q(w.validator_index),
        "address": _d(w.address),
        "amount": _q(w.amount),
    }


_REQUEST_FIELDS = (("deposits", 0), ("withdrawals", 1), ("consolidations", 2))


def execution_requests_to_json(er) -> List[str]:
    """ExecutionRequests container -> Prague engine encoding: one DATA item
    per non-empty request type, ``type_byte || ssz(list)``."""
    out = []
    for field, type_byte in _REQUEST_FIELDS:
        items = list(getattr(er, field))
        if items:
            blob = er.fields[field].serialize(items)
            out.append("0x%02x" % type_byte + blob.hex())
    return out


def execution_requests_from_json(lst, types):
    """Inverse of :func:`execution_requests_to_json`."""
    by_type = {t: f for f, t in _REQUEST_FIELDS}
    kwargs = {f: [] for f, _ in _REQUEST_FIELDS}
    cls = types.ExecutionRequests
    for item in lst or []:
        raw = bytes.fromhex(item[2:] if item.startswith("0x") else item)
        if not raw:
            continue
        field = by_type.get(raw[0])
        if field is None:
            raise EngineApiError(f"unknown execution request type {raw[0]}")
        kwargs[field] = cls.fields[field].deserialize(raw[1:])
    return cls(**kwargs)


def _body_from_json(obj) -> Optional[Dict[str, Any]]:
    """ExecutionPayloadBodyV1 JSON -> normalized dict (or None)."""
    if obj is None:
        return None
    return {
        "transactions": [bytes.fromhex(t[2:]) for t in obj.get("transactions", [])],
        "withdrawals": list(obj.get("withdrawals") or []),
    }


def kzg_commitment_to_versioned_hash(commitment: bytes) -> bytes:
    """EIP-4844 versioned hash: 0x01 || sha256(commitment)[1:]."""
    from hashlib import sha256

    return b"\x01" + sha256(bytes(commitment)).digest()[1:]


def payload_to_json(payload) -> Dict[str, Any]:
    """ExecutionPayload container -> engine-API ExecutionPayloadV1/2/3 JSON."""
    out = {
        "parentHash": _d(payload.parent_hash),
        "feeRecipient": _d(payload.fee_recipient),
        "stateRoot": _d(payload.state_root),
        "receiptsRoot": _d(payload.receipts_root),
        "logsBloom": _d(payload.logs_bloom),
        "prevRandao": _d(payload.prev_randao),
        "blockNumber": _q(payload.block_number),
        "gasLimit": _q(payload.gas_limit),
        "gasUsed": _q(payload.gas_used),
        "timestamp": _q(payload.timestamp),
        "extraData": _d(payload.extra_data),
        "baseFeePerGas": _q(payload.base_fee_per_gas),
        "blockHash": _d(payload.block_hash),
        "transactions": [_d(tx) for tx in payload.transactions],
    }
    if hasattr(payload, "withdrawals"):
        out["withdrawals"] = [withdrawal_to_json(w) for w in payload.withdrawals]
    if hasattr(payload, "blob_gas_used"):
        out["blobGasUsed"] = _q(payload.blob_gas_used)
        out["excessBlobGas"] = _q(payload.excess_blob_gas)
    return out


def payload_from_json(obj: Dict[str, Any], types, fork: str):
    """Engine-API JSON -> the fork's ExecutionPayload container."""
    cls = {
        "bellatrix": types.ExecutionPayloadBellatrix,
        "capella": types.ExecutionPayloadCapella,
        "deneb": types.ExecutionPayloadDeneb,
        "electra": types.ExecutionPayloadDeneb,  # structurally identical
    }[fork]
    kwargs = dict(
        parent_hash=bytes.fromhex(obj["parentHash"][2:]),
        fee_recipient=bytes.fromhex(obj["feeRecipient"][2:]),
        state_root=bytes.fromhex(obj["stateRoot"][2:]),
        receipts_root=bytes.fromhex(obj["receiptsRoot"][2:]),
        logs_bloom=bytes.fromhex(obj["logsBloom"][2:]),
        prev_randao=bytes.fromhex(obj["prevRandao"][2:]),
        block_number=int(obj["blockNumber"], 16),
        gas_limit=int(obj["gasLimit"], 16),
        gas_used=int(obj["gasUsed"], 16),
        timestamp=int(obj["timestamp"], 16),
        extra_data=bytes.fromhex(obj["extraData"][2:]),
        base_fee_per_gas=int(obj["baseFeePerGas"], 16),
        block_hash=bytes.fromhex(obj["blockHash"][2:]),
        transactions=[bytes.fromhex(tx[2:]) for tx in obj["transactions"]],
    )
    if fork in ("capella", "deneb", "electra"):
        kwargs["withdrawals"] = [
            types.Withdrawal(
                index=int(w["index"], 16),
                validator_index=int(w["validatorIndex"], 16),
                address=bytes.fromhex(w["address"][2:]),
                amount=int(w["amount"], 16),
            )
            for w in obj.get("withdrawals", [])
        ]
    if fork in ("deneb", "electra"):
        kwargs["blob_gas_used"] = int(obj.get("blobGasUsed", "0x0"), 16)
        kwargs["excess_blob_gas"] = int(obj.get("excessBlobGas", "0x0"), 16)
    return cls(**kwargs)


# ----------------------------------------------------------------- client


class EngineApiClient:
    def __init__(self, url: str, jwt_secret: bytes, timeout: float = 8.0):
        self.url = url
        self.jwt_secret = jwt_secret
        self.timeout = timeout
        self._id = 0

    def rpc(self, method: str, params: List[Any]) -> Any:
        self._id += 1
        body = json.dumps({
            "jsonrpc": "2.0", "id": self._id, "method": method, "params": params,
        }).encode()
        req = urllib.request.Request(
            self.url,
            data=body,
            method="POST",
            headers={
                "Content-Type": "application/json",
                "Authorization": "Bearer " + auth.generate_token(self.jwt_secret),
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            # An HTTP status from the engine is NOT "offline": 401 is an auth
            # failure the operator must see (engines.rs State::AuthFailed).
            detail = e.read().decode(errors="replace")[:200]
            if e.code == 401:
                raise EngineApiError(f"auth failed (401): {detail}", e.code) from None
            raise EngineApiError(f"engine HTTP {e.code}: {detail}", e.code) from None
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise EngineOffline(f"engine unreachable: {e}") from None
        if "error" in payload and payload["error"]:
            err = payload["error"]
            raise EngineApiError(err.get("message", "rpc error"), err.get("code"))
        return payload.get("result")

    # ------------------------------------------------------------- methods

    def exchange_capabilities(self) -> List[str]:
        return self.rpc("engine_exchangeCapabilities", [SUPPORTED_METHODS])

    def new_payload(self, payload, fork: str,
                    versioned_hashes: Optional[List[bytes]] = None,
                    parent_beacon_block_root: Optional[bytes] = None,
                    execution_requests: Optional[List[str]] = None) -> Dict[str, Any]:
        """engine_newPayloadV1-V4 by fork; returns the PayloadStatus.
        ``execution_requests``: Prague's encoded request list (V4)."""
        pj = payload_to_json(payload)
        if fork == "electra":
            return self.rpc("engine_newPayloadV4", [
                pj,
                [_d(h) for h in (versioned_hashes or [])],
                _d(parent_beacon_block_root or b"\x00" * 32),
                execution_requests or [],
            ])
        if fork == "deneb":
            return self.rpc("engine_newPayloadV3", [
                pj,
                [_d(h) for h in (versioned_hashes or [])],
                _d(parent_beacon_block_root or b"\x00" * 32),
            ])
        version = "engine_newPayloadV2" if fork == "capella" else "engine_newPayloadV1"
        return self.rpc(version, [pj])

    def forkchoice_updated(self, *, head_block_hash: bytes,
                           safe_block_hash: bytes,
                           finalized_block_hash: bytes,
                           fork: str,
                           payload_attributes: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        state = {
            "headBlockHash": _d(head_block_hash),
            "safeBlockHash": _d(safe_block_hash),
            "finalizedBlockHash": _d(finalized_block_hash),
        }
        version = {
            "bellatrix": "engine_forkchoiceUpdatedV1",
            "capella": "engine_forkchoiceUpdatedV2",
            "deneb": "engine_forkchoiceUpdatedV3",
        }.get(fork, "engine_forkchoiceUpdatedV3")
        return self.rpc(version, [state, payload_attributes])

    def get_payload(self, payload_id: str, fork: str) -> Dict[str, Any]:
        version = {
            "bellatrix": "engine_getPayloadV1",
            "capella": "engine_getPayloadV2",
            "deneb": "engine_getPayloadV3",
            "electra": "engine_getPayloadV4",
        }.get(fork, "engine_getPayloadV3")
        return self.rpc(version, [payload_id])

    def get_payload_bodies_by_hash(self, hashes) -> list:
        """engine_getPayloadBodiesByHashV1: normalized body dicts
        ({transactions: [bytes], withdrawals: [json]}) or None per hash."""
        res = self.rpc(
            "engine_getPayloadBodiesByHashV1",
            [["0x" + bytes(h).hex() for h in hashes]],
        )
        return [_body_from_json(b) for b in (res or [])]

    def get_payload_bodies_by_range(self, start: int, count: int) -> list:
        res = self.rpc("engine_getPayloadBodiesByRangeV1", [_q(start), _q(count)])
        return [_body_from_json(b) for b in (res or [])]

    def get_client_version(self) -> Optional[Dict[str, str]]:
        """engine_getClientVersionV1: the EL identifies itself (we identify
        ourselves in the request, per the spec's mutual exchange)."""
        from .. import __version__

        res = self.rpc("engine_getClientVersionV1", [{
            "code": "LH", "name": "lighthouse-tpu",
            "version": __version__, "commit": "00000000",
        }])
        return res[0] if res else None
