"""Networking: gossip pub/sub, req/resp RPC, peer management, sync
(reference: ``beacon_node/lighthouse_network`` + ``beacon_node/network``).

A copy of the JAX package's ``lighthouse_tpu/network/__init__.py``, with
the same exports.
"""

from . import rpc, snappy_codec, topics
from .node import LocalNode
from .peer_manager import PeerAction, PeerManager
from .router import Router
from .service import NetworkService, message_id
from .sync import SyncManager, SyncState
from .transport import Envelope, Hub

__all__ = [
    "Envelope",
    "Hub",
    "LocalNode",
    "NetworkService",
    "PeerAction",
    "PeerManager",
    "Router",
    "SyncManager",
    "SyncState",
    "message_id",
    "rpc",
    "snappy_codec",
    "topics",
]
