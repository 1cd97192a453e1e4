"""VC keymanager HTTP API.

Equivalent of the reference's ``validator_client/src/http_api`` (the
standard keymanager-API surface ``validator_manager`` drives): list / import
/ delete keystores and remote (Web3Signer) keys, Bearer-token
authenticated (the reference's ``api-token.txt``).

Routes (keymanager-specs):
    GET    /eth/v1/keystores
    POST   /eth/v1/keystores            {keystores[], passwords[], slashing_protection?}
    DELETE /eth/v1/keystores            {pubkeys[]} -> slashing_protection export
    GET    /eth/v1/remotekeys
    POST   /eth/v1/remotekeys           {remote_keys: [{pubkey, url}]}
    DELETE /eth/v1/remotekeys           {pubkeys[]}

A copy of the JAX package's ``lighthouse_tpu/validator_client/keymanager.py``.
"""

from __future__ import annotations

import json
import re
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from .validator_store import ValidatorStore
from .web3signer import Web3SignerClient


_SETTINGS_ROUTE = re.compile(
    r"/eth/v1/validator/(0x[0-9a-fA-F]{96})/"
    r"(feerecipient|gas_limit|graffiti)$")


class KeymanagerServer:
    def __init__(self, *, store: ValidatorStore, genesis_validators_root: bytes,
                 port: int = 0, token: Optional[str] = None,
                 preparation=None, blocks=None):
        self.store = store
        self.genesis_validators_root = bytes(genesis_validators_root)
        self.token = token if token is not None else secrets.token_hex(16)
        self._port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._remote_urls: Dict[bytes, str] = {}
        # per-validator settings (keymanager-specs feerecipient/gas_limit/
        # graffiti routes).  When the VC's services are wired in, settings
        # are LIVE: fee recipients flow into proposer preparations and
        # graffiti overrides the file/flag at proposal time.
        self.preparation = preparation
        self.blocks = blocks
        # standalone fallback stores, used only when the corresponding VC
        # service is not wired in (ONE owner per setting otherwise)
        self._fee_recipients: Dict[bytes, bytes] = {}
        self._gas_limits: Dict[bytes, int] = {}
        self._graffiti: Dict[bytes, bytes] = {}

    def _fee_map(self) -> Dict[bytes, bytes]:
        if self.preparation is not None:
            return self.preparation.per_validator
        return self._fee_recipients

    def _purge_validator_settings(self, pubkey: bytes) -> None:
        """A deleted key's settings must not survive to a future
        re-import (a new operator would silently inherit them)."""
        self._fee_map().pop(pubkey, None)
        self._fee_recipients.pop(pubkey, None)
        self._gas_limits.pop(pubkey, None)
        self._graffiti.pop(pubkey, None)
        if self.blocks is not None:
            self.blocks.keymanager_graffiti.pop(pubkey, None)

    # ------------------------------------------------------------ handlers

    def _list_keystores(self) -> dict:
        return {"data": [
            {"validating_pubkey": "0x" + pk.hex(), "derivation_path": "", "readonly": False}
            for pk in self.store._by_pubkey
        ]}

    def _import_keystores(self, body: dict) -> dict:
        from ..crypto import keystore as ks

        keystores = body.get("keystores") or []
        passwords = body.get("passwords") or []
        if len(keystores) != len(passwords):
            raise ValueError("keystores and passwords length mismatch")
        interchange = body.get("slashing_protection")
        if interchange:
            self.store.slashing_db.import_json(
                interchange if isinstance(interchange, str) else json.dumps(interchange),
                self.genesis_validators_root,
            )
        statuses = []
        for raw, password in zip(keystores, passwords):
            try:
                obj = json.loads(raw) if isinstance(raw, str) else raw
                sk = ks.load_keystore_signing_key(obj, password)
                pk = self.store.add_key(sk)
                statuses.append({"status": "imported", "message": "0x" + pk.hex()})
            except Exception as e:
                statuses.append({"status": "error", "message": str(e)})
        return {"data": statuses}

    def _delete_keystores(self, body: dict) -> dict:
        pubkeys = [bytes.fromhex(p[2:]) for p in (body.get("pubkeys") or [])]
        statuses = []
        for pk in pubkeys:
            # typed endpoint: only LOCAL keystores; remote keys have their
            # own DELETE with different (no-protection-export) semantics
            removed = self.store.remove_local_key(pk)
            if removed:
                self._purge_validator_settings(pk)
            statuses.append({"status": "deleted" if removed else "not_found"})
        # Per keymanager-specs, deletion returns the protection history so
        # keys can migrate without double-sign risk.
        export = self.store.slashing_db.export_json(self.genesis_validators_root)
        return {"data": statuses, "slashing_protection": export}

    def _list_remotekeys(self) -> dict:
        return {"data": [
            {"pubkey": "0x" + pk.hex(), "url": url, "readonly": False}
            for pk, url in self._remote_urls.items()
        ]}

    def _import_remotekeys(self, body: dict) -> dict:
        statuses = []
        for entry in body.get("remote_keys") or []:
            try:
                pk = bytes.fromhex(entry["pubkey"][2:])
                url = entry["url"]
                if self.store.has_key(pk):
                    # keymanager-specs: duplicates are reported, never
                    # silently rerouting a locally-held key to a remote
                    statuses.append({"status": "duplicate"})
                    continue
                self.store.add_remote_key(pk, Web3SignerClient(url))
                self._remote_urls[pk] = url
                statuses.append({"status": "imported"})
            except Exception as e:
                statuses.append({"status": "error", "message": str(e)})
        return {"data": statuses}

    def _delete_remotekeys(self, body: dict) -> dict:
        statuses = []
        for p in body.get("pubkeys") or []:
            pk = bytes.fromhex(p[2:])
            removed = self.store.remove_remote_key(pk)
            self._remote_urls.pop(pk, None)
            if removed:
                self._purge_validator_settings(pk)
            statuses.append({"status": "deleted" if removed else "not_found"})
        return {"data": statuses}

    def _validator_setting(self, method: str, pubkey: bytes, kind: str,
                           body: dict):
        """keymanager-specs per-validator settings.  GET returns the value,
        POST sets (202), DELETE resets (204)."""
        hexkey = "0x" + pubkey.hex()
        if kind == "feerecipient":
            if method == "GET":
                cur = self._fee_map().get(pubkey)
                if cur is None and self.preparation is not None:
                    # the EFFECTIVE value: the VC-level default applies
                    # when no per-validator override exists
                    cur = self.preparation.fee_recipient
                return 200, {"data": {"pubkey": hexkey,
                                      "ethaddress": "0x" + (cur or b"\x00" * 20).hex()}}
            if method == "POST":
                addr = bytes.fromhex(str(body["ethaddress"])[2:])
                if len(addr) != 20:
                    raise ValueError("ethaddress must be 20 bytes")
                self._fee_map()[pubkey] = addr
                return 202, None
            self._fee_map().pop(pubkey, None)
            return 204, None
        if kind == "gas_limit":
            if method == "GET":
                return 200, {"data": {"pubkey": hexkey,
                                      "gas_limit": str(self._gas_limits.get(
                                          pubkey, 30_000_000))}}
            if method == "POST":
                self._gas_limits[pubkey] = int(body["gas_limit"])
                return 202, None
            self._gas_limits.pop(pubkey, None)
            return 204, None
        # graffiti — the SERVER owns the setting (it must round-trip even
        # standalone); the block service mirror makes it live at proposal
        if method == "GET":
            cur = self._graffiti.get(pubkey)
            if cur is None and self.blocks is not None:
                cur = self.blocks._graffiti_for(pubkey)  # effective value
            return 200, {"data": {"pubkey": hexkey,
                                  "graffiti": (cur or b"").rstrip(b"\x00").decode(
                                      "utf-8", "replace")}}
        if method == "POST":
            raw = str(body["graffiti"]).encode()
            if len(raw) > 32:
                raise ValueError("graffiti exceeds 32 bytes")
            padded = raw.ljust(32, b"\x00")
            self._graffiti[pubkey] = padded
            if self.blocks is not None:
                self.blocks.keymanager_graffiti[pubkey] = padded
            return 202, None
        self._graffiti.pop(pubkey, None)
        if self.blocks is not None:
            self.blocks.keymanager_graffiti.pop(pubkey, None)
        return 204, None

    # -------------------------------------------------------------- server

    def start(self) -> "KeymanagerServer":
        km = self

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

            def _authed(self) -> bool:
                auth = self.headers.get("Authorization", "")
                return auth == f"Bearer {km.token}"

            def _dispatch(self, method: str):
                if not self._authed():
                    self._reply(401, {"message": "invalid or missing Bearer token"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length)) if length else {}
                except json.JSONDecodeError as e:
                    self._reply(400, {"message": f"malformed JSON body: {e}"})
                    return
                path = self.path.split("?")[0].rstrip("/")
                try:
                    if path.endswith("/eth/v1/keystores"):
                        if method == "GET":
                            self._reply(200, km._list_keystores())
                        elif method == "POST":
                            self._reply(200, km._import_keystores(body))
                        else:
                            self._reply(200, km._delete_keystores(body))
                        return
                    if path.endswith("/eth/v1/remotekeys"):
                        if method == "GET":
                            self._reply(200, km._list_remotekeys())
                        elif method == "POST":
                            self._reply(200, km._import_remotekeys(body))
                        else:
                            self._reply(200, km._delete_remotekeys(body))
                        return
                    m = _SETTINGS_ROUTE.search(path)
                    if m:
                        pubkey = bytes.fromhex(m.group(1)[2:])
                        if not km.store.has_key(pubkey):
                            self._reply(404, {"message": "unknown validator"})
                            return
                        code, obj = km._validator_setting(
                            method, pubkey, m.group(2), body)
                        self._reply(code, obj)
                        return
                except (ValueError, KeyError) as e:
                    self._reply(400, {"message": str(e)})
                    return
                self._reply(404, {"message": "unknown route"})

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_DELETE(self):
                self._dispatch("DELETE")

        self._server = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
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


class KeymanagerClient:
    """The ``validator_manager``-side client."""

    def __init__(self, base_url: str, token: str, timeout: float = 5.0):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout

    def _request(self, method: str, path: str, body=None):
        import urllib.request

        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.token}",
            },
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            raw = resp.read()
            return json.loads(raw) if raw else None

    def list_keystores(self) -> List[dict]:
        return self._request("GET", "/eth/v1/keystores")["data"]

    def import_keystores(self, keystores: List[dict], passwords: List[str],
                         slashing_protection: Optional[str] = None) -> List[dict]:
        body = {"keystores": [json.dumps(k) for k in keystores],
                "passwords": passwords}
        if slashing_protection:
            body["slashing_protection"] = slashing_protection
        return self._request("POST", "/eth/v1/keystores", body)["data"]

    def delete_keystores(self, pubkeys: List[bytes]) -> dict:
        return self._request(
            "DELETE", "/eth/v1/keystores",
            {"pubkeys": ["0x" + bytes(p).hex() for p in pubkeys]},
        )

    def list_remotekeys(self) -> List[dict]:
        return self._request("GET", "/eth/v1/remotekeys")["data"]

    def import_remotekeys(self, entries: List[dict]) -> List[dict]:
        return self._request("POST", "/eth/v1/remotekeys",
                             {"remote_keys": entries})["data"]
