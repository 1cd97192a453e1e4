"""In-process beacon node: chain + scheduler + network service + router +
sync, wired on the hub fabric.

The building block of the N-node simulator (reference:
``testing/node_test_rig`` ``LocalBeaconNode`` + ``testing/simulator``).

A copy of the JAX package's ``lighthouse_tpu/network/node.py``.  On a
socket endpoint (``tcp_transport.TcpEndpoint``) ``enable_discv5``,
``discover_peers_discv5`` and ``discover_peers`` find and dial peers over
the wire, and shutdown persists the discv5 table (``persisted_dht``);
``discover_peers`` returns 0 on the in-process hub, whose topology is
explicit.
"""

from __future__ import annotations

from typing import Optional

from ..chain import BeaconChain, BeaconChainHarness
from ..scheduler import BeaconProcessor
from . import topics as topics_mod
from .peer_manager import PeerAction
from .router import Router
from .service import NetworkService
from .sync import SyncManager
from .transport import Hub


class LocalNode:
    def __init__(
        self,
        *,
        hub: Optional[Hub] = None,
        peer_id: str,
        harness: Optional[BeaconChainHarness] = None,
        chain: Optional[BeaconChain] = None,
        max_workers: int = 2,
        bls_backend: Optional[str] = None,
        enable_slasher: bool = False,
        slasher_config=None,
        endpoint=None,
        subscribe_all_subnets: bool = True,
        scope=None,
        clock=None,
    ):
        if harness is not None:
            chain = harness.chain
        assert chain is not None
        if bls_backend is not None:
            # Node assembly selects the execution backend ("torch" = the
            # batched multi-pairing on the card, "host", "fake"); tests pass
            # None to keep whatever the harness configured (fake/host).
            from ..crypto.bls.backends import set_backend

            set_backend(bls_backend)
        self.harness = harness
        self.chain = chain
        self.peer_id = peer_id
        # transport seam: in-process hub (simulators) or a provided endpoint
        # (e.g. TcpEndpoint — two OS processes over sockets)
        if endpoint is not None:
            self.endpoint = endpoint
        else:
            assert hub is not None, "pass hub= or endpoint="
            self.endpoint = hub.register(peer_id)
        # Node telemetry scope: stamps outbound envelopes with this node's
        # trace context and receives deferred fleet-journal events.
        self.scope = scope
        self.endpoint.scope = scope
        # clock: optional callable threaded into peer scoring so decay and
        # ban lifts run on the simulator's virtual clock during scenarios
        self.service = NetworkService(self.endpoint, clock=clock)
        self.processor = BeaconProcessor(max_workers=max_workers)
        self.slasher = None
        if enable_slasher:
            from ..slasher import Slasher, SlasherConfig

            self.slasher = Slasher(
                chain.types,
                slasher_config
                or SlasherConfig(slots_per_epoch=chain.spec.slots_per_epoch),
            )
        self.router = Router(
            chain=chain, service=self.service, processor=self.processor,
            slasher=self.slasher, scope=scope,
        )
        self.sync = SyncManager(chain=chain, service=self.service, router=self.router)
        digest = self.router.fork_digest
        fork = type(chain.genesis_state).fork_name
        for topic in topics_mod.core_topics(digest, fork, chain.spec):
            self.service.subscribe(str(topic))
        # Attestation/sync subnets go through the subnet service (reference
        # subnet_service/): backbone rotation + VC duty subscriptions.
        # subscribe_all (the --subscribe-all-subnets flag) is the right
        # default for small in-process networks, where 2 backbone subnets
        # per node would partition subnet traffic.
        import hashlib as _hashlib

        from .subnet_service import SubnetService

        self.subnets = SubnetService(
            service=self.service, digest=digest, spec=chain.spec,
            node_id=int.from_bytes(
                _hashlib.sha256(peer_id.encode()).digest(), "big"),
            subscribe_all=subscribe_all_subnets,
        )
        if not subscribe_all_subnets:
            self.subnets.update_epoch(0)

    # ----------------------------------------------------------- discovery

    def enable_discv5(self, keypair=None):
        """Attach a discv5-over-UDP discovery service whose ENR advertises
        BOTH our discovery (udp) port and the TCP fabric listen port — the
        reference node's discovery/transport split (discv5 finds peers,
        libp2p dials them)."""
        from .discv5 import Discv5Service, KeyPair
        from .discv5.enr import ENR

        self.discv5 = Discv5Service(keypair or KeyPair())
        host, tcp_port = self.endpoint.listen_addr
        # Advertise the FABRIC's host for the tcp entry (falling back to
        # the discovery socket's when the fabric binds a wildcard) — peers
        # dial what the ENR says.
        ip = self.discv5.ip if host in ("0.0.0.0", "") else host
        from .subnet_service import attnets_bitfield

        # The spec keys compute_subscribed_subnets to the DISCOVERY node id
        # so peers can predict our backbone subnets from the ENR — re-seed
        # the subnet service BEFORE minting the ENR, or the record would
        # advertise the stale (peer-id-derived) backbone.
        self.subnets.node_id = int.from_bytes(self.discv5.node_id, "big")
        if not self.subnets.subscribe_all:
            self.subnets.update_epoch(
                self.chain.current_slot() // self.chain.spec.slots_per_epoch)
        active = self.subnets.active_attestation_subnets()
        sync_active = self.subnets.active_sync_subnets()
        self._enr_ip, self._enr_tcp = ip, tcp_port
        self._advertised_subnets = (set(active), set(sync_active))
        self.discv5.enr = ENR.build(
            self.discv5.keypair, seq=1, ip=ip,
            udp=self.discv5.port, tcp=tcp_port,
            extra={b"attnets": attnets_bitfield(active),
                   b"syncnets": attnets_bitfield(
                       sync_active, self.chain.spec.sync_committee_subnet_count)},
        )
        # the SAME bits in req/resp metadata — one encoder, so the two
        # advertisements cannot drift
        self.router.metadata.attnets = int.from_bytes(
            attnets_bitfield(active), "little")
        self.router.metadata.syncnets = int.from_bytes(
            attnets_bitfield(sync_active,
                             self.chain.spec.sync_committee_subnet_count),
            "little")
        self.router.metadata.seq_number += 1
        # Seed the routing table from the persisted DHT (persisted_dht.rs:
        # a restarted node re-joins without fresh bootstrap rounds).
        from .persisted_dht import load_dht

        for enr in load_dht(self.chain.store):
            try:
                self.discv5.add_enr(enr)
            except Exception:
                continue  # one stale record must not stop discovery
        self.discv5.start()
        return self.discv5

    def refresh_subnet_advertisement(self) -> bool:
        """Re-mint the ENR (seq+1) and bump MetaData.seq_number when the
        active subnet set changed (backbone rotation / duty expiry) — a
        stale record makes peers dial us for subnets we left.  Called from
        the per-slot tick; returns True when a refresh happened."""
        if getattr(self, "discv5", None) is None:
            return False
        from .discv5.enr import ENR
        from .subnet_service import attnets_bitfield

        active = set(self.subnets.active_attestation_subnets())
        sync_active = set(self.subnets.active_sync_subnets())
        if (active, sync_active) == self._advertised_subnets:
            return False
        self._advertised_subnets = (active, sync_active)
        self.discv5.enr = ENR.build(
            self.discv5.keypair, seq=self.discv5.enr.seq + 1,
            ip=self._enr_ip, udp=self.discv5.port, tcp=self._enr_tcp,
            extra={b"attnets": attnets_bitfield(active),
                   b"syncnets": attnets_bitfield(
                       sync_active, self.chain.spec.sync_committee_subnet_count)},
        )
        self.router.metadata.attnets = int.from_bytes(
            attnets_bitfield(active), "little")
        self.router.metadata.syncnets = int.from_bytes(
            attnets_bitfield(sync_active,
                             self.chain.spec.sync_committee_subnet_count),
            "little")
        self.router.metadata.seq_number += 1
        return True

    def _dial_new_addrs(self, addrs, max_new: int) -> int:
        """Dial every address not already known, up to ``max_new`` — the
        shared tail of both discovery flavors."""
        endpoint = self.endpoint
        known = set(endpoint.known_peer_addrs().values())
        known.add(tuple(endpoint.listen_addr))
        dialed = 0
        for addr in addrs:
            if addr in known:
                continue
            try:
                endpoint.dial(*addr, timeout=3.0)
                known.add(addr)
                dialed += 1
            except Exception:
                continue  # stale address: skip
            if dialed >= max_new:
                break
        return dialed

    def discover_peers_discv5(self, boot_enrs, max_new: int = 8,
                              prefer_subnets=None) -> int:
        """One discv5 discovery round: bootstrap FINDNODE sweeps against the
        boot ENRs, then dial discovered records that advertise a TCP port —
        records advertising any of ``prefer_subnets`` in their attnets
        field first (reference discovery/subnet_predicate.rs; defaults to
        our own active subnets when running a real backbone).  Returns
        #dialed."""
        from .discv5 import rlp as discv5_rlp
        from .subnet_service import subnet_predicate

        if getattr(self, "discv5", None) is None:
            return 0
        if prefer_subnets is None and not self.subnets.subscribe_all:
            prefer_subnets = self.subnets.active_attestation_subnets()
        for boot in boot_enrs:
            try:
                self.discv5.bootstrap(boot)
            except Exception:
                continue
        preferred, rest = [], []
        for enr in list(self.discv5.table.values()):
            tcp_raw = enr.pairs.get(b"tcp")
            ip = enr.ip()
            if not tcp_raw or ip is None:
                continue
            try:
                addr = (ip, discv5_rlp.decode_uint(tcp_raw))
            except Exception:
                continue  # one malformed record must not veto the round
            (preferred if subnet_predicate(enr, prefer_subnets or ())
             else rest).append(addr)
        return self._dial_new_addrs(preferred + rest, max_new)

    def discover_peers(self, max_new: int = 8) -> int:
        """One discovery round (the FINDNODE sweep a discv5 node runs):
        ask every connected peer — boot nodes included — for the listen
        addresses they know, dial the unknown ones.  Returns #dialed.
        Requires a socket-backed endpoint (TcpEndpoint)."""
        from . import rpc as rpc_mod

        endpoint = self.endpoint
        if not hasattr(endpoint, "dial"):
            return 0  # in-process hub: topology is explicit
        dialed = 0
        for peer in list(endpoint.connected_peers()):
            if dialed >= max_new:
                break  # stop issuing RPCs once the round's budget is met
            try:
                chunks = self.service.request(
                    peer, rpc_mod.PEER_EXCHANGE,
                    rpc_mod.PeerExchangeRequest(max_peers=64),
                )
            except rpc_mod.RpcError:
                continue
            addrs = []
            for result, payload, _ctx in chunks:
                if result != rpc_mod.SUCCESS:
                    continue
                try:
                    entries = rpc_mod.decode_peer_entries(payload)
                except Exception:
                    # one malformed answer must not veto the whole round
                    self.service.peer_manager.report(
                        peer, PeerAction.LOW_TOLERANCE, "bad peer-exchange payload"
                    )
                    continue
                addrs.extend(
                    (e.host, e.port) for e in entries
                    if e.peer_id != self.peer_id
                )
            dialed += self._dial_new_addrs(addrs, max_new - dialed)
        return dialed

    # ------------------------------------------------------------ publish

    def publish_block(self, signed_block) -> int:
        topic = topics_mod.GossipTopic(self.router.fork_digest, topics_mod.BEACON_BLOCK)
        n = self.service.publish(str(topic), signed_block.as_ssz_bytes())
        # A locally-produced block may have queued LC updates at import —
        # publish them now rather than waiting for the next gossip block.
        self.router._publish_light_client_updates()
        return n

    def publish_blob_sidecar(self, sidecar) -> int:
        subnet = int(sidecar.index) % self.chain.spec.max_blobs_per_block
        topic = topics_mod.GossipTopic(
            self.router.fork_digest, f"{topics_mod.BLOB_SIDECAR_PREFIX}{subnet}"
        )
        return self.service.publish(str(topic), sidecar.as_ssz_bytes())

    def publish_operation(self, kind: str, op) -> int:
        """Gossip a pool operation on its global topic (voluntary_exit /
        proposer_slashing / attester_slashing / bls_to_execution_change)."""
        topic = topics_mod.GossipTopic(self.router.fork_digest, kind)
        return self.service.publish(str(topic), op.as_ssz_bytes())

    def publish_attestation(self, attestation) -> int:
        subnet = topics_mod.compute_subnet_for_attestation(
            self.chain.head_state,
            int(attestation.data.slot),
            int(attestation.data.index),
            self.chain.spec,
        )
        topic = topics_mod.attestation_subnet_topic(self.router.fork_digest, subnet)
        return self.service.publish(str(topic), attestation.as_ssz_bytes())

    def wait_idle(self, timeout: float = 10.0) -> bool:
        return self.processor.wait_idle(timeout)

    def shutdown(self) -> None:
        # Goodbye(1 = client shutdown) to every peer BEFORE tearing the
        # stack down (reference: lighthouse sends Goodbye on shutdown so
        # peers drop the connection cleanly instead of scoring a timeout).
        from . import rpc as rpc_mod
        from .transport import Envelope

        goodbye = rpc_mod.Goodbye(reason=1)
        for peer in list(self.endpoint.connected_peers()):
            try:
                self.endpoint.send(peer, Envelope(
                    kind="rpc_request", sender=self.peer_id,
                    protocol=rpc_mod.GOODBYE, request_id=0,
                    data=rpc_mod.encode_request(rpc_mod.GOODBYE, goodbye),
                ))
            except Exception:
                continue  # best-effort PER PEER; one failure must not
                # silence the goodbye to everyone else
        self.service.shutdown()
        self.router.reprocess.shutdown()
        # unhook from the chain: a restarted node (SimNode.resurrect, same
        # chain object) must not leave imports feeding a dead queue
        try:
            self.chain.block_imported_hooks.remove(
                self.router.reprocess.block_imported)
        except ValueError:
            pass
        self.processor.shutdown()
        if getattr(self, "discv5", None) is not None:
            # persist the routing table for the next start (persisted_dht.rs)
            try:
                from .persisted_dht import persist_dht

                persist_dht(self.chain.store, list(self.discv5.table.values()))
            except Exception:
                pass  # persistence is best-effort; shutdown must proceed
            self.discv5.stop()
        if hasattr(self.endpoint, "close"):
            self.endpoint.close()  # socket-backed endpoints own OS resources
