"""Web3Signer remote signing.

Equivalent of the reference's ``signing_method.rs:80-91`` (the
``SigningMethod::Web3Signer`` arm) + the ``testing/web3signer_tests`` rig:
signatures come from an external signer over HTTP; the VC never holds the
secret key.  The mock server plays the Java Web3Signer's role in tests and
asserts remote signatures are byte-identical to local ones — the reference's
own acceptance criterion (``web3signer_tests/src/lib.rs:1-13``).

Wire format (Web3Signer ETH2 API subset): POST
``/api/v1/eth2/sign/0x{pubkey}`` with ``{"signing_root": "0x…"}`` →
``{"signature": "0x…"}``.

A copy of the JAX package's ``lighthouse_tpu/validator_client/web3signer.py``.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional


class Web3SignerError(Exception):
    pass


class Web3SignerClient:
    """The VC-side remote signer (pluggable into
    ``ValidatorStore.add_remote_key``).

    Requests carry a timeout and, on *connection* errors only, one
    jittered-backoff retry (``web3signer_retries_total{kind}``) — the same
    degrade-and-recover discipline as ``Engine.upcheck``'s cooldown in
    ``execution_layer/engines.py``.  HTTP-level errors (4xx/5xx) are signer
    verdicts and never retried; a duty window is ~4 s, so the backoff is
    capped well below it.
    """

    def __init__(self, base_url: str, timeout: float = 5.0,
                 retries: int = 1, backoff_s: float = 0.2):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = max(0, int(retries))
        self.backoff_s = backoff_s

    def _request(self, req: "urllib.request.Request", kind: str):
        """urlopen + parse with bounded connection-error retries."""
        from .. import fault_injection, metrics

        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            if attempt:
                # Jittered backoff: a fleet of VCs hammered by the same
                # signer blip must not retry in lockstep.
                time.sleep(self.backoff_s * (1.0 + random.random()))
                metrics.WEB3SIGNER_RETRIES.inc(kind=kind)
            try:
                fault_injection.check("signer.request")
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as e:
                # The signer answered: its verdict stands, no retry.
                raise Web3SignerError(
                    f"signer {e.code}: {e.read().decode(errors='replace')}"
                ) from None
            except (OSError, fault_injection.InjectedFault) as e:
                last = e
        raise Web3SignerError(f"signer unreachable: {last}") from None

    def sign(self, pubkey: bytes, signing_root: bytes) -> bytes:
        body = json.dumps({"signing_root": "0x" + bytes(signing_root).hex()}).encode()
        req = urllib.request.Request(
            f"{self.base_url}/api/v1/eth2/sign/0x{bytes(pubkey).hex()}",
            data=body, method="POST",
            headers={"Content-Type": "application/json"},
        )
        obj = self._request(req, kind="sign")
        try:
            return bytes.fromhex(obj["signature"][2:])
        except (KeyError, TypeError, ValueError) as e:
            raise Web3SignerError(f"malformed signer response: {e}") from None

    def public_keys(self) -> list:
        req = urllib.request.Request(
            f"{self.base_url}/api/v1/eth2/publicKeys", method="GET"
        )
        return [
            bytes.fromhex(s[2:])
            for s in self._request(req, kind="public_keys")
        ]


class MockWeb3Signer:
    """In-process signer holding real secret keys (the Java Web3Signer's
    role in the reference's test rig)."""

    def __init__(self, secret_keys):
        self._keys: Dict[bytes, object] = {
            sk.public_key().to_bytes(): sk for sk in secret_keys
        }
        self.sign_requests = 0
        self._server: Optional[ThreadingHTTPServer] = None

    def start(self) -> "MockWeb3Signer":
        signer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
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
                if self.path.endswith("/api/v1/eth2/publicKeys"):
                    self._reply(200, ["0x" + pk.hex() for pk in signer._keys])
                    return
                self._reply(404, {"error": "unknown route"})

            def do_POST(self):
                if "/api/v1/eth2/sign/0x" not in self.path:
                    self._reply(404, {"error": "unknown route"})
                    return
                pk = bytes.fromhex(self.path.rsplit("/0x", 1)[1])
                sk = signer._keys.get(pk)
                if sk is None:
                    self._reply(404, {"error": "unknown key"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                obj = json.loads(self.rfile.read(length))
                root = bytes.fromhex(obj["signing_root"][2:])
                signer.sign_requests += 1
                self._reply(200, {"signature": "0x" + sk.sign(root).to_bytes().hex()})

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
