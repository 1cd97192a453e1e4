"""Boot node: a standalone peer-introduction service.

Equivalent of the reference's ``boot_node/`` binary (609 LoC — a discv5-only
process new nodes contact first).  In this stack's transport idiom the
bootstrap role is peer exchange over TCP: the boot node accepts connections,
remembers every dialer's listen address, and answers ``peer_exchange/1`` with
the addresses it knows — it never gossips, serves blocks, or holds chain
state.

Node-side, ``discover_peers`` (on ``LocalNode``) walks connected peers'
exchange answers and dials unknown addresses — the FINDNODE round of discv5.

A copy of the JAX package's ``lighthouse_tpu/network/boot_node.py``.
"""

from __future__ import annotations

import threading
from typing import Optional

from . import rpc as rpc_mod
from .service import NetworkService
from .tcp_transport import TcpEndpoint


class BootNode:
    def __init__(self, *, peer_id: str = "boot", host: str = "127.0.0.1",
                 port: int = 0):
        self.endpoint = TcpEndpoint(peer_id, host=host, port=port)
        self.service = NetworkService(self.endpoint)
        self.service.on_rpc_request = self._on_rpc

    @property
    def listen_addr(self):
        return self.endpoint.listen_addr

    def _on_rpc(self, protocol: str, request, sender: str):
        if protocol == rpc_mod.PING:
            return [rpc_mod.encode_response_chunk(
                rpc_mod.SUCCESS, rpc_mod.Ping(0).to_bytes()
            )]
        if protocol == rpc_mod.PEER_EXCHANGE:
            return [rpc_mod.serve_peer_exchange(
                self.endpoint, sender, request.max_peers
            )]
        if protocol == rpc_mod.GOODBYE:
            self.endpoint.disconnect(sender)
            return []
        return [rpc_mod.encode_response_chunk(
            rpc_mod.INVALID_REQUEST, b"boot node serves discovery only"
        )]

    def stop(self) -> None:
        self.service.shutdown()
        self.endpoint.close()


def run_forever(host: str, port: int) -> None:  # pragma: no cover - CLI loop
    import time

    node = BootNode(host=host, port=port)
    print(f"boot node listening on {node.listen_addr[0]}:{node.listen_addr[1]}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        node.stop()
