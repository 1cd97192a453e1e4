"""Beacon-node HTTP API: server (reference ``beacon_node/http_api``), typed
client (``common/eth2``), and the beacon-API JSON serde layer.

A copy of the JAX package's ``lighthouse_tpu/http_api``.
"""

from .client import ApiClientError, BeaconNodeHttpClient
from .serde import container_from_json, to_json
from .server import ApiError, HttpApiServer

__all__ = [
    "ApiClientError",
    "ApiError",
    "BeaconNodeHttpClient",
    "HttpApiServer",
    "container_from_json",
    "to_json",
]
