"""Typed beacon-node HTTP client.

Equivalent of the reference's ``common/eth2`` crate (``BeaconNodeHttpClient``
— the client the validator client, lcli, and tests drive every beacon node
through).  stdlib ``urllib`` over TCP; JSON wire format.

A copy of the JAX package's ``lighthouse_tpu/http_api/client.py``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from .serde import container_from_json, to_json


class ApiClientError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class BeaconNodeHttpClient:
    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # ------------------------------------------------------------- plumbing

    def _request(self, method: str, path: str, body: Any = None,
                 headers: Optional[Dict[str, str]] = None) -> Any:
        url = self.base_url + path
        data = None
        hdrs = {"Accept": "application/json"}
        if body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        if headers:
            hdrs.update(headers)
        req = urllib.request.Request(url, data=data, method=method, headers=hdrs)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw = resp.read()
                if not raw:
                    return None
                return json.loads(raw)
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                payload = json.loads(raw)
                msg = payload.get("message", raw.decode(errors="replace"))
            except (json.JSONDecodeError, AttributeError):
                msg = raw.decode(errors="replace")
            raise ApiClientError(e.code, msg) from None

    def get(self, path: str) -> Any:
        return self._request("GET", path)

    def get_ssz(self, path: str):
        """GET with ``Accept: application/octet-stream``; returns
        ``(raw_bytes, consensus_version)`` — the checkpoint-sync fetch shape.
        Errors surface as ``ApiClientError`` like every other method."""
        req = urllib.request.Request(
            self.base_url + path,
            headers={"Accept": "application/octet-stream"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                ctype = (resp.headers.get("Content-Type") or "").lower()
                if "application/octet-stream" not in ctype:
                    # 406 Not Acceptable: an HTTP-200 with the wrong type is
                    # still a failed negotiation from the caller's view
                    raise ApiClientError(
                        406,
                        f"server answered {ctype!r}, not SSZ — it does not "
                        "support octet-stream on this route",
                    )
                return resp.read(), resp.headers.get("Eth-Consensus-Version")
        except urllib.error.HTTPError as e:
            try:
                msg = e.read().decode(errors="replace")
            except Exception:
                msg = str(e)
            raise ApiClientError(e.code, msg) from None

    def post(self, path: str, body: Any = None,
             headers: Optional[Dict[str, str]] = None) -> Any:
        return self._request("POST", path, body, headers)

    # ----------------------------------------------------------------- node

    def node_version(self) -> str:
        return self.get("/eth/v1/node/version")["data"]["version"]

    def node_syncing(self) -> dict:
        return self.get("/eth/v1/node/syncing")["data"]

    def node_health_ok(self) -> bool:
        try:
            self.get("/eth/v1/node/health")
            return True
        except ApiClientError:
            return False

    # --------------------------------------------------------------- beacon

    def genesis(self) -> dict:
        return self.get("/eth/v1/beacon/genesis")["data"]

    def state_fork(self, state_id: str = "head") -> dict:
        return self.get(f"/eth/v1/beacon/states/{state_id}/fork")["data"]

    def state_root(self, state_id: str = "head") -> bytes:
        data = self.get(f"/eth/v1/beacon/states/{state_id}/root")["data"]
        return bytes.fromhex(data["root"][2:])

    def finality_checkpoints(self, state_id: str = "head") -> dict:
        return self.get(f"/eth/v1/beacon/states/{state_id}/finality_checkpoints")["data"]

    def validators(self, state_id: str = "head",
                   ids: Optional[List[str]] = None) -> List[dict]:
        path = f"/eth/v1/beacon/states/{state_id}/validators"
        if ids:
            path += "?id=" + ",".join(str(i) for i in ids)
        return self.get(path)["data"]

    def block_header(self, block_id: str = "head") -> dict:
        return self.get(f"/eth/v1/beacon/headers/{block_id}")["data"]

    def block(self, block_id: str = "head") -> dict:
        return self.get(f"/eth/v2/beacon/blocks/{block_id}")

    def block_root(self, block_id: str = "head") -> bytes:
        data = self.get(f"/eth/v1/beacon/blocks/{block_id}/root")["data"]
        return bytes.fromhex(data["root"][2:])

    def publish_block(self, signed_block) -> None:
        fork = type(signed_block.message).fork_name
        self.post(
            "/eth/v2/beacon/blocks",
            to_json(signed_block),
            headers={"Eth-Consensus-Version": fork},
        )

    def submit_attestations(self, attestations) -> None:
        self.post(
            "/eth/v1/beacon/pool/attestations",
            [to_json(a) for a in attestations],
        )

    def submit_voluntary_exit(self, signed_exit) -> None:
        self.post("/eth/v1/beacon/pool/voluntary_exits", to_json(signed_exit))

    def produce_blinded_block(self, slot: int, randao_reveal: bytes,
                              graffiti: Optional[bytes] = None) -> dict:
        path = (f"/eth/v1/validator/blinded_blocks/{slot}"
                f"?randao_reveal=0x{bytes(randao_reveal).hex()}")
        if graffiti:
            path += f"&graffiti=0x{bytes(graffiti).hex()}"
        return self.get(path)

    def publish_blinded_block(self, signed_blinded_block) -> None:
        fork = type(signed_blinded_block.message).fork_name
        self.post(
            "/eth/v2/beacon/blinded_blocks",
            to_json(signed_blinded_block),
            headers={"Eth-Consensus-Version": fork},
        )

    def register_validator(self, signed_registrations) -> None:
        self.post(
            "/eth/v1/validator/register_validator",
            [to_json(r) for r in signed_registrations],
        )

    def submit_sync_committee_messages(self, messages) -> None:
        self.post(
            "/eth/v1/beacon/pool/sync_committees",
            [to_json(m) for m in messages],
        )

    def sync_duties(self, epoch: int, indices: List[int]) -> dict:
        return self.post(
            f"/eth/v1/validator/duties/sync/{epoch}",
            [str(i) for i in indices],
        )

    def sync_committee_contribution(self, slot: int, subcommittee_index: int,
                                    beacon_block_root: bytes, types=None):
        data = self.get(
            f"/eth/v1/validator/sync_committee_contribution"
            f"?slot={slot}&subcommittee_index={subcommittee_index}"
            f"&beacon_block_root=0x{bytes(beacon_block_root).hex()}"
        )["data"]
        if types is not None:
            return container_from_json(types.SyncCommitteeContribution, data)
        return data

    def publish_contribution_and_proofs(self, signed_contributions) -> None:
        self.post(
            "/eth/v1/validator/contribution_and_proofs",
            [to_json(c) for c in signed_contributions],
        )

    @staticmethod
    def _lc_era(branch, header_json=None) -> str:
        """Era from wire shape: 6/7-element state branches are electra
        (64-leaf state); otherwise the header tells capella vs deneb vs
        the beacon-only altair format (blob-gas fields are deneb-only)."""
        if len(branch) >= 6:
            return "electra"
        execution = (header_json or {}).get("execution")
        if execution is None:
            return "altair"
        return "deneb" if "blob_gas_used" in execution else "capella"

    def light_client_bootstrap(self, block_root: bytes, types=None):
        data = self.get(
            f"/eth/v1/beacon/light_client/bootstrap/0x{bytes(block_root).hex()}"
        )["data"]
        if types is not None:
            era = self._lc_era(data["current_sync_committee_branch"],
                               data.get("header"))
            return container_from_json(types.light_client[era]["bootstrap"], data)
        return data

    def light_client_updates(self, start_period: int, count: int, types=None):
        entries = self.get(
            f"/eth/v1/beacon/light_client/updates"
            f"?start_period={start_period}&count={count}"
        )
        if types is not None:
            return [
                container_from_json(
                    types.light_client[
                        self._lc_era(e["data"]["next_sync_committee_branch"],
                                     e["data"].get("attested_header"))
                    ]["update"],
                    e["data"],
                )
                for e in entries
            ]
        return entries

    def light_client_finality_update(self, types=None):
        data = self.get("/eth/v1/beacon/light_client/finality_update")["data"]
        if types is not None:
            branch = data["finality_branch"]
            era = ("electra" if len(branch) >= 7 else
                   self._lc_era([], data.get("attested_header")))
            return container_from_json(
                types.light_client[era]["finality_update"], data
            )
        return data

    def light_client_optimistic_update(self, types=None):
        data = self.get("/eth/v1/beacon/light_client/optimistic_update")["data"]
        if types is not None:
            # No branch on the wire: the header shape is the only signal
            # (electra optimistic updates share deneb's header).
            era = self._lc_era([], data.get("attested_header"))
            return container_from_json(
                types.light_client[era]["optimistic_update"], data)
        return data

    def prepare_beacon_proposer(self, preparations: List[dict]) -> None:
        self.post("/eth/v1/validator/prepare_beacon_proposer", preparations)

    def liveness(self, epoch: int, indices: List[int]) -> List[dict]:
        return self.post(
            f"/eth/v1/validator/liveness/{epoch}",
            [str(i) for i in indices],
        )["data"]

    # ------------------------------------------------------------ validator

    def proposer_duties(self, epoch: int) -> dict:
        return self.get(f"/eth/v1/validator/duties/proposer/{epoch}")

    def attester_duties(self, epoch: int, indices: List[int]) -> dict:
        return self.post(
            f"/eth/v1/validator/duties/attester/{epoch}",
            [str(i) for i in indices],
        )

    def sync_duties(self, epoch: int, indices: List[int]) -> dict:
        return self.post(
            f"/eth/v1/validator/duties/sync/{epoch}",
            [str(i) for i in indices],
        )

    def produce_block(self, slot: int, randao_reveal: bytes,
                      graffiti: Optional[bytes] = None) -> dict:
        path = f"/eth/v3/validator/blocks/{slot}?randao_reveal=0x{randao_reveal.hex()}"
        if graffiti:
            path += f"&graffiti=0x{graffiti.hex()}"
        return self.get(path)

    def attestation_data(self, slot: int, committee_index: int, types=None):
        data = self.get(
            f"/eth/v1/validator/attestation_data?slot={slot}"
            f"&committee_index={committee_index}"
        )["data"]
        if types is not None:
            return container_from_json(types.AttestationData, data)
        return data

    def aggregate_attestation(self, slot: int, data_root: bytes, types=None,
                              committee_index=None):
        """``committee_index`` (v2/electra): post-electra all committees share
        one data root, so the pool needs it to return OUR committee's
        aggregate — without it an aggregator can be handed another
        committee's aggregate and fail the BN's committee-membership check."""
        url = (
            f"/eth/v2/validator/aggregate_attestation"
            f"?attestation_data_root=0x{data_root.hex()}&slot={slot}"
        )
        if committee_index is not None:
            url += f"&committee_index={int(committee_index)}"
        data = self.get(url)["data"]
        if types is not None:
            return container_from_json(types.Attestation, data)
        return data

    def publish_aggregate_and_proofs(self, signed_aggregates) -> None:
        self.post(
            "/eth/v1/validator/aggregate_and_proofs",
            [to_json(a) for a in signed_aggregates],
        )

    # --------------------------------------------------------------- config

    def config_spec(self) -> dict:
        return self.get("/eth/v1/config/spec")["data"]
