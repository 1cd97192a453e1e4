"""External block-builder (MEV relay) client + in-process mock relay.

Equivalent of the reference's ``beacon_node/builder_client`` (228 LoC HTTP
client: register_validators / get_header / submit_blinded_block against the
builder-specs API) plus the ``MockBuilder`` test relay the reference keeps in
``execution_layer/test_utils``.

The flow (reference ``http_api/src/produce_block.rs`` + builder bid
validation in ``execution_layer``):

1. VC registers fee recipients (``register_validators``).
2. At proposal time the BN asks ``get_header(slot, parent_hash, pubkey)``;
   the relay answers with a ``SignedBuilderBid`` carrying a payload HEADER
   and a value.
3. The BN builds a BLINDED block around the header; the proposer signs it.
4. ``submit_blinded_block`` reveals the full payload; because
   ``header.hash_tree_root() == payload.hash_tree_root()`` the proposer's
   signature is valid for the unblinded block, which the BN imports and
   publishes.

A copy of the JAX package's
``lighthouse_tpu/execution_layer/builder_client.py``.  The chain checks a
bid's signature through ``crypto.bls.api``: on the card with the port's
default ``"torch"`` backend.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..consensus import helpers as h
from ..consensus.per_block import execution_payload_to_header
from ..crypto.bls import api as bls
from ..http_api.serde import container_from_json, to_json
from ..types.spec import DOMAIN_APPLICATION_BUILDER


class BuilderError(Exception):
    pass


def builder_signing_root(message_root: bytes, spec) -> bytes:
    """Builder-API objects sign over the APPLICATION_BUILDER domain with the
    genesis fork version and an empty genesis-validators-root (builder-specs;
    reference ``signed_validator_registration`` verification)."""
    domain = h.compute_domain(
        DOMAIN_APPLICATION_BUILDER, spec.genesis_fork_version, None
    )
    return h.compute_signing_root(message_root, domain)


class BuilderHttpClient:
    """The BN-side relay client (reference ``builder_client/src/lib.rs``)."""

    def __init__(self, base_url: str, timeout: float = 5.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _request(self, method: str, path: str, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw = resp.read()
                return json.loads(raw) if raw else None
        except urllib.error.HTTPError as e:
            raise BuilderError(f"builder {e.code}: {e.read().decode(errors='replace')}") from None
        except OSError as e:
            raise BuilderError(f"builder unreachable: {e}") from None

    def register_validators(self, signed_registrations) -> None:
        self._request(
            "POST", "/eth/v1/builder/validators",
            [to_json(r) for r in signed_registrations],
        )

    def get_header(self, slot: int, parent_hash: bytes, pubkey: bytes, types):
        resp = self._request(
            "GET",
            f"/eth/v1/builder/header/{slot}/0x{bytes(parent_hash).hex()}"
            f"/0x{bytes(pubkey).hex()}",
        )
        if resp is None:
            return None, None
        # Relay output is untrusted: any malformed answer is a BuilderError
        # so callers' local-production fallback engages.
        try:
            fork = resp["version"]
            bid = container_from_json(types.signed_builder_bid[fork], resp["data"])
        except (KeyError, TypeError, ValueError) as e:
            raise BuilderError(f"malformed builder bid: {e}") from e
        return fork, bid

    def submit_blinded_block(self, signed_blinded_block, types):
        fork = type(signed_blinded_block.message).fork_name
        resp = self._request(
            "POST", "/eth/v1/builder/blinded_blocks",
            to_json(signed_blinded_block),
        )
        payload_cls = types.execution_payload[fork]
        try:
            return container_from_json(payload_cls, resp["data"])
        except (KeyError, TypeError, ValueError) as e:
            raise BuilderError(f"malformed revealed payload: {e}") from e


class MockRelay:
    """In-process relay: builds payloads exactly like the mock EL (so bids
    validate against the chain's state), signs bids with its own key, and
    reveals payloads on submission (reference ``MockBuilder``)."""

    def __init__(self, chain, bid_value: int = 1_000_000_000):
        self.chain = chain
        self.bid_value = bid_value
        self.key = bls.SecretKey(0x42424242)
        self.pubkey = self.key.public_key().to_bytes()
        self.registrations: Dict[bytes, object] = {}  # pubkey -> registration
        self._payloads: Dict[bytes, object] = {}  # header root -> payload
        self._server: Optional[ThreadingHTTPServer] = None

    # ------------------------------------------------------------ behavior

    def build_bid(self, slot: int, parent_hash: bytes):
        chain = self.chain
        types, spec = chain.types, chain.spec
        state, _ = chain.state_at_slot(slot)
        if bytes(state.latest_execution_payload_header.block_hash) != bytes(parent_hash):
            raise BuilderError("unknown parent hash")
        fork = type(state).fork_name
        requests = None
        if fork == "electra" and hasattr(
            chain.execution_engine, "produce_payload_and_requests"
        ):
            payload, requests = chain.execution_engine.produce_payload_and_requests(
                state, types, spec
            )
        else:
            payload = chain.execution_engine.produce_payload(state, types, spec)
        header = execution_payload_to_header(payload, types, fork)
        self._payloads[header.hash_tree_root()] = payload
        bid_kwargs = dict(header=header, value=self.bid_value, pubkey=self.pubkey)
        if "blob_kzg_commitments" in types.builder_bid[fork].fields:
            bid_kwargs["blob_kzg_commitments"] = []
        if "execution_requests" in types.builder_bid[fork].fields:
            bid_kwargs["execution_requests"] = (
                requests if requests is not None
                else types.ExecutionRequests(
                    deposits=[], withdrawals=[], consolidations=[])
            )
        bid = types.builder_bid[fork](**bid_kwargs)
        sig = self.key.sign(builder_signing_root(bid.hash_tree_root(), spec))
        return fork, types.signed_builder_bid[fork](
            message=bid, signature=sig.to_bytes()
        )

    def reveal_payload(self, signed_blinded_block):
        header = signed_blinded_block.message.body.execution_payload_header
        payload = self._payloads.get(header.hash_tree_root())
        if payload is None:
            raise BuilderError("no payload for that header (not our bid)")
        return payload

    # -------------------------------------------------------------- server

    def start(self) -> "MockRelay":
        relay = self
        chain = self.chain

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, obj=None):
                body = b"" if obj is None else json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                # eth/v1/builder/header/{slot}/{parent_hash}/{pubkey}
                if len(parts) == 7 and parts[:4] == ["eth", "v1", "builder", "header"]:
                    try:
                        fork, bid = relay.build_bid(
                            int(parts[4]), bytes.fromhex(parts[5][2:])
                        )
                    except Exception as e:
                        self._reply(400, {"code": 400, "message": str(e)})
                        return
                    self._reply(200, {"version": fork, "data": to_json(bid)})
                    return
                if parts[-1] == "status":
                    self._reply(200)
                    return
                self._reply(404, {"code": 404, "message": "unknown route"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"null")
                if self.path.endswith("/eth/v1/builder/validators"):
                    for reg in body or []:
                        signed = container_from_json(
                            chain.types.SignedValidatorRegistrationV1, reg
                        )
                        relay.registrations[
                            bytes(signed.message.pubkey)
                        ] = signed
                    self._reply(200)
                    return
                if self.path.endswith("/eth/v1/builder/blinded_blocks"):
                    fork = None
                    # newest fork first: older bodies are field-subsets and
                    # could otherwise swallow a newer block's JSON
                    for f, cls in reversed(list(chain.types.signed_blinded_block.items())):
                        try:
                            signed = container_from_json(cls, body)
                            fork = f
                            break
                        except Exception:
                            continue
                    if fork is None:
                        self._reply(400, {"code": 400, "message": "undecodable block"})
                        return
                    try:
                        payload = relay.reveal_payload(signed)
                    except BuilderError as e:
                        self._reply(400, {"code": 400, "message": str(e)})
                        return
                    self._reply(200, {"version": fork, "data": to_json(payload)})
                    return
                self._reply(404, {"code": 404, "message": "unknown route"})

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
