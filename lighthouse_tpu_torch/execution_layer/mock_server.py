"""Mock execution engine served over real HTTP JSON-RPC with JWT auth.

Equivalent of the reference's ``execution_layer/src/test_utils/`` MockServer:
the same fake-EL semantics as ``chain/mock_el.py`` but behind an actual
socket speaking the engine API, so the ``ExecutionLayer`` client, JWT auth,
capability exchange, and the offline→online state machine are all exercised
for real.

A copy of the JAX package's
``lighthouse_tpu/execution_layer/mock_server.py``.
"""

from __future__ import annotations

import json
import threading
from hashlib import sha256
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Set

from . import auth
from .engine_api import SUPPORTED_METHODS


class MockEngineServer:
    def __init__(self, jwt_secret: bytes, host: str = "127.0.0.1", port: int = 0):
        self.jwt_secret = jwt_secret
        self.head_hash = b"\x00" * 32
        self.finalized_hash = b"\x00" * 32
        self.block_number = 0
        self.invalid_hashes: Set[bytes] = set()
        self.syncing_hashes: Set[bytes] = set()
        self.payloads_seen = 0
        self.fcu_seen = 0
        self._payload_id = 0
        self._pending: Dict[str, dict] = {}  # payloadId -> {head, attributes}
        # block_hash -> ExecutionPayloadBodyV1 JSON, for
        # engine_getPayloadBodiesByHash/Range (payload reconstruction).
        self._bodies: Dict[bytes, dict] = {}
        self._lock = threading.Lock()

        server = ThreadingHTTPServer((host, port), _Handler)
        server.mock = self  # type: ignore[attr-defined]
        server.daemon_threads = True
        self._httpd = server
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "MockEngineServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="mock-engine", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # ------------------------------------------------------------- methods

    def handle(self, method: str, params: list):
        if method == "engine_exchangeCapabilities":
            return SUPPORTED_METHODS
        if method.startswith("engine_newPayload"):
            payload = params[0]
            self.payloads_seen += 1
            block_hash = bytes.fromhex(payload["blockHash"][2:])
            with self._lock:
                self._bodies[block_hash] = {
                    "blockNumber": payload.get("blockNumber", "0x0"),
                    "transactions": list(payload.get("transactions", [])),
                    "withdrawals": payload.get("withdrawals"),
                }
            if block_hash in self.invalid_hashes:
                return {"status": "INVALID", "latestValidHash": None,
                        "validationError": "marked invalid by test"}
            if block_hash in self.syncing_hashes:
                return {"status": "SYNCING", "latestValidHash": None}
            return {"status": "VALID",
                    "latestValidHash": payload["blockHash"]}
        if method.startswith("engine_forkchoiceUpdated"):
            state, attributes = params[0], params[1] if len(params) > 1 else None
            self.fcu_seen += 1
            with self._lock:
                self.head_hash = bytes.fromhex(state["headBlockHash"][2:])
                self.finalized_hash = bytes.fromhex(state["finalizedBlockHash"][2:])
                result = {
                    "payloadStatus": {"status": "VALID",
                                      "latestValidHash": state["headBlockHash"]},
                    "payloadId": None,
                }
                if attributes:
                    self._payload_id += 1
                    pid = "0x" + self._payload_id.to_bytes(8, "big").hex()
                    self._pending[pid] = {
                        "head": self.head_hash, "attributes": attributes,
                    }
                    result["payloadId"] = pid
            return result
        if method == "engine_getClientVersionV1":
            return [{"code": "MK", "name": "mock-engine",
                     "version": "0.1.0", "commit": "deadbeef"}]
        if method == "engine_getPayloadBodiesByHashV1":
            with self._lock:
                return [
                    self._body_json(self._bodies.get(bytes.fromhex(h[2:])))
                    for h in params[0]
                ]
        if method == "engine_getPayloadBodiesByRangeV1":
            start, count = int(params[0], 16), int(params[1], 16)
            with self._lock:
                by_number = {
                    int(b["blockNumber"], 16): b for b in self._bodies.values()
                }
                return [
                    self._body_json(by_number.get(n))
                    for n in range(start, start + count)
                ]
        if method.startswith("engine_getPayload"):
            pid = params[0]
            with self._lock:
                pending = self._pending.pop(pid, None)
            if pending is None:
                raise _RpcError(-38001, "Unknown payload")
            payload = self._build_payload(pending["head"], pending["attributes"])
            if method.endswith("V1"):
                return payload
            out = {"executionPayload": payload, "blockValue": "0x0"}
            if method.endswith("V3") or method.endswith("V4"):
                out["blobsBundle"] = {"commitments": [], "proofs": [], "blobs": []}
                out["shouldOverrideBuilder"] = False
            if method.endswith("V4"):
                out["executionRequests"] = []
            return out
        raise _RpcError(-32601, f"method not found: {method}")

    @staticmethod
    def _body_json(body: Optional[dict]) -> Optional[dict]:
        if body is None:
            return None
        return {"transactions": body["transactions"],
                "withdrawals": body["withdrawals"]}

    def _build_payload(self, head: bytes, attrs: dict) -> dict:
        with self._lock:
            self.block_number += 1
            number = self.block_number
        timestamp = attrs["timestamp"]
        block_hash = sha256(
            b"mock-engine" + head + bytes.fromhex(timestamp[2:].zfill(16))
            + number.to_bytes(8, "big")
        ).digest()
        out = {
            "parentHash": "0x" + head.hex(),
            "feeRecipient": attrs.get("suggestedFeeRecipient", "0x" + "00" * 20),
            "stateRoot": "0x" + "00" * 32,
            "receiptsRoot": "0x" + "00" * 32,
            "logsBloom": "0x" + "00" * 256,
            "prevRandao": attrs["prevRandao"],
            "blockNumber": hex(number),
            "gasLimit": hex(30_000_000),
            "gasUsed": "0x0",
            "timestamp": timestamp,
            "extraData": "0x",
            "baseFeePerGas": "0x7",
            "blockHash": "0x" + block_hash.hex(),
            "transactions": [],
        }
        if "withdrawals" in attrs:
            out["withdrawals"] = attrs["withdrawals"]
        if "parentBeaconBlockRoot" in attrs:
            out["blobGasUsed"] = "0x0"
            out["excessBlobGas"] = "0x0"
        with self._lock:
            self._bodies[block_hash] = {
                "blockNumber": out["blockNumber"],
                "transactions": list(out["transactions"]),
                "withdrawals": out.get("withdrawals"),
            }
        return out


class _RpcError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def do_POST(self):
        mock: MockEngineServer = self.server.mock  # type: ignore[attr-defined]
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length)
        # JWT gate (auth.rs semantics): missing/invalid token -> 401.
        header = self.headers.get("Authorization", "")
        token = header[len("Bearer "):] if header.startswith("Bearer ") else ""
        try:
            auth.validate_token(token, mock.jwt_secret)
        except auth.JwtError as e:
            self._respond(401, {"error": f"unauthorized: {e}"})
            return
        try:
            req = json.loads(raw)
            result = mock.handle(req.get("method", ""), req.get("params", []))
            self._respond(200, {"jsonrpc": "2.0", "id": req.get("id"), "result": result})
        except _RpcError as e:
            self._respond(200, {
                "jsonrpc": "2.0", "id": None,
                "error": {"code": e.code, "message": e.message},
            })
        except Exception as e:
            self._respond(200, {
                "jsonrpc": "2.0", "id": None,
                "error": {"code": -32603, "message": f"{type(e).__name__}: {e}"},
            })

    def _respond(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
