"""Beacon-node HTTP API (reference ``beacon_node/http_api``).

Only the beacon-API JSON serde layer (``serde.py``, a copy of the JAX
package's) is here so far: the builder client needs ``to_json`` and
``container_from_json``.  The server and the typed client come with the
rest of the HTTP API.
"""

from .serde import container_from_json, to_json

__all__ = [
    "container_from_json",
    "to_json",
]
