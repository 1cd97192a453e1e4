"""Client assembly and runtime: the staged builder, the per-slot timer, the
notifier, and shutdown orchestration.

Equivalent of the reference's ``beacon_node/client`` crate
(``builder.rs:109-1008`` ``ClientBuilder`` — staged construction of
store → chain → network → http; ``notifier.rs`` — the per-slot status log)
plus ``common/task_executor`` (``lib.rs:169-258`` — spawn/shutdown of the
service tasks).

A copy of the JAX package's ``lighthouse_tpu/client/__init__.py``.  The
builder defaults the BLS backend to ``"torch"`` (``LIGHTHOUSE_TPU_BLS_BACKEND``
overrides it) and the device to the card (``with_device("cuda")``): every
device route of the node (BLS batches, tree hashing, the epoch programs,
the device pipeline) runs there, and ``build()`` raises before anything is
served where there is no card.  ``with_device("cpu")`` runs the CUDA
kernels' plain PyTorch versions, as the tests do.  On the card ``build()``
builds the kernel libraries (``ops.compile_cache.build_kernels``) where the
JAX package configures its XLA compile cache; after it, as in the JAX
package, ``ops.compile_cache.maybe_warmup_from_env`` starts the
standard-bucket warmup where ``LIGHTHOUSE_TPU_AOT_WARMUP`` asks for it
(``bn --aot-warmup``; a warmup that fails on the card raises on its
thread).  Then, as in the JAX package, the device mesh (``device_mesh.configure()``,
``LIGHTHOUSE_TPU_MESH``) and the autotune controller
(``autotune.maybe_start_from_env``, ``LIGHTHOUSE_TPU_AUTOTUNE``); on the
card a mesh or autotune setup that fails raises out of ``build()`` (the
JAX package logs a warning), with ``with_device("cpu")`` it logs one.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

from ..chain import BeaconChain
from ..chain.slot_clock import SystemTimeSlotClock
from ..scheduler import BeaconProcessor
from ..types.containers import build_types
from ..types.spec import ChainSpec, mainnet_spec

from ..logs import get_logger

log = get_logger("client")


class ClientBuilder:
    """Staged assembly; each ``with_*`` returns self (builder.rs style)."""

    def __init__(self):
        self._spec: Optional[ChainSpec] = None
        self._genesis_state = None
        self._datadir: Optional[str] = None
        self._el_url: Optional[str] = None
        self._el_jwt: Optional[bytes] = None
        self._http_port: Optional[int] = None
        self._metrics = True
        self._slasher = False
        self._bls_backend = os.environ.get("LIGHTHOUSE_TPU_BLS_BACKEND", "torch")
        self._device = "cuda"
        self._max_workers = 4
        self._kzg = None

    def with_spec(self, spec: ChainSpec) -> "ClientBuilder":
        self._spec = spec
        return self

    def with_genesis_state(self, state) -> "ClientBuilder":
        self._genesis_state = state
        return self

    def with_interop_genesis(self, validator_count: int,
                             genesis_time: Optional[int] = None) -> "ClientBuilder":
        from ..consensus.genesis import interop_genesis_state
        import time as _time

        spec = self._spec or mainnet_spec()
        self._spec = spec
        types = build_types(spec.preset)
        self._genesis_state = interop_genesis_state(
            validator_count, types, spec,
            genesis_time=int(_time.time()) if genesis_time is None else genesis_time,
        )
        return self

    def with_datadir(self, path: str) -> "ClientBuilder":
        self._datadir = path
        return self

    def with_execution_layer(self, url: str, jwt_secret: bytes) -> "ClientBuilder":
        self._el_url = url
        self._el_jwt = jwt_secret
        return self

    def with_http_api(self, port: int = 5052) -> "ClientBuilder":
        self._http_port = port
        return self

    def with_checkpoint_sync(self, url: str) -> "ClientBuilder":
        """Boot from a trusted node's FINALIZED checkpoint instead of genesis
        (reference ``builder.rs:341-528`` weak-subjectivity sync): fetch the
        finalized block + its post-state as SSZ over the standard API and
        anchor the chain there; backfill fills history behind it."""
        self._checkpoint_url = url
        return self

    def with_network(self, *, listen_port: int = 0, listen_address: str = "0.0.0.0",
                     peers=None, boot_nodes=None) -> "ClientBuilder":
        """Join the p2p fabric over TCP: listen, dial static peers and boot
        nodes, discover the rest (reference: the network stage of
        builder.rs wiring lighthouse_network + router + sync)."""
        self._net_listen = (listen_address, listen_port)
        self._net_peers = list(peers or [])
        self._net_boot_nodes = list(boot_nodes or [])
        return self

    def with_monitoring(self, endpoint: str,
                        update_period: float = 60.0) -> "ClientBuilder":
        """Push node stats to a remote client-stats endpoint (reference
        ``common/monitoring_api`` / the --monitoring-endpoint flag)."""
        self._monitoring_endpoint = endpoint
        self._monitoring_period = update_period
        return self

    def with_slasher(self, enabled: bool = True) -> "ClientBuilder":
        self._slasher = enabled
        return self

    def with_bls_backend(self, name: str) -> "ClientBuilder":
        self._bls_backend = name
        return self

    def with_kzg(self, kzg) -> "ClientBuilder":
        self._kzg = kzg
        return self

    def with_device(self, device: str) -> "ClientBuilder":
        """The device of every device route: ``"cuda"`` (the default) or
        ``"cpu"`` (the CUDA kernels' plain versions).  The routes switch at
        once, so a genesis state built after this call is hashed there;
        ``"cuda"`` raises where there is no card."""
        if device not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {device!r} (cuda or cpu)")
        self._device = device
        self._route_device()
        return self

    def _route_device(self) -> None:
        """Point the BLS backend, tree hashing and the epoch programs at the
        builder's device; raises where it names a card this machine lacks."""
        from ..consensus import per_epoch
        from ..crypto.bls.backends import torch_backend
        from ..ops import tree_hash
        from ..ops.devices import resolve_device

        try:
            resolve_device(self._device)
        except RuntimeError as e:
            raise RuntimeError(
                f"no CUDA card for the node ({e}); pass --device cpu to run the "
                "kernels' plain versions on the CPU") from None
        from ..ops import compile_cache

        torch_backend.configure(device=self._device)
        tree_hash.configure(enabled=True, device=self._device)
        per_epoch.configure(backend="device", device=self._device)
        compile_cache.configure(device=self._device)  # autotune's warmups

    def _configure_device(self) -> None:
        """Route every device path to the builder's device; on the card,
        build the kernel libraries first; then the device mesh, the
        pipeline and the autotune controller."""
        from .. import autotune, device_mesh, device_pipeline

        from ..ops import compile_cache

        self._route_device()
        if self._device == "cuda":
            t = time.perf_counter()
            compile_cache.build_kernels()
            log.info("kernel libraries ready in %.2f s", time.perf_counter() - t)
        if self._bls_backend == "torch":
            # Standard-bucket warmup (ops/compile_cache.py): with
            # LIGHTHOUSE_TPU_AOT_WARMUP=1 (bn --aot-warmup) one neutral verify
            # a standard bucket runs on a background thread, so its first
            # dispatch's cost is paid before the first batch arrives.
            self._runtime_setup("bucket warmup", compile_cache.maybe_warmup_from_env)
        # Mesh sharding (device_mesh.py): LIGHTHOUSE_TPU_MESH=N|auto shards
        # the bucketed device ops' batch axis over the visible cards,
        # configured at assembly so the topology is logged and gauged before
        # traffic arrives; fewer than 2 cards stays single-device.
        self._runtime_setup("device mesh", device_mesh.configure)
        if self._bls_backend == "torch":
            # Async device pipeline (device_pipeline.py): production nodes
            # stream every signature-set group through the persistent device
            # worker so block import / gossip / sync-committee work coalesce
            # into maximal device batches.  LIGHTHOUSE_TPU_DEVICE_PIPELINE=0
            # opts out (device_pipeline.enable honors it).
            device_pipeline.enable(device=self._device)
        # Self-tuning control plane (autotune.py): under
        # LIGHTHOUSE_TPU_AUTOTUNE=live this measures the proposer walk's
        # lookahead on the card (cached per card, torch and CUDA) and starts
        # the periodic controller; the default mode (pinned) starts nothing.
        self._runtime_setup("autotune",
                            lambda: autotune.maybe_start_from_env(device=self._device))

    def _runtime_setup(self, what: str, fn) -> None:
        """Run one optional runtime setup: on the card a failure raises out
        of ``build()``, elsewhere it is logged and the node goes on."""
        try:
            fn()
        except Exception:
            if self._device == "cuda":
                raise
            log.warning("%s setup failed", what, exc_info=True)

    # ----------------------------------------------------------------- build

    def _checkpoint_fetch(self, types):
        """Fetch (anchor_state, anchor_block) from the trusted URL."""
        from ..http_api.client import BeaconNodeHttpClient

        remote = BeaconNodeHttpClient(self._checkpoint_url, timeout=30.0)
        root = remote.block_root("finalized")
        raw_block, fork = remote.get_ssz(f"/eth/v2/beacon/blocks/0x{root.hex()}")
        if fork is None:
            # no consensus-version header: derive the fork from the slot at
            # its fixed SSZ offset (message offset word + 96-byte signature)
            slot = int.from_bytes(raw_block[100:108], "little")
            fork = self._spec.fork_name_at_slot(slot)
        if fork not in types.signed_block:
            raise ValueError(f"checkpoint provider sent unknown fork {fork!r}")
        anchor_block = types.signed_block[fork].from_ssz_bytes(raw_block)
        if anchor_block.message.hash_tree_root() != root:
            # The URL may be plain HTTP and the provider is only *semi*
            # trusted: without this check a tampered response could anchor
            # the node on a different block while still passing the
            # state-root check below.
            raise ValueError(
                "checkpoint provider served a block that does not match the "
                "finalized root it advertised — refusing the anchor"
            )
        state_root = bytes(anchor_block.message.state_root)
        raw_state, sfork = remote.get_ssz(
            f"/eth/v2/debug/beacon/states/0x{state_root.hex()}"
        )
        anchor_state = types.state[sfork or fork].from_ssz_bytes(raw_state)
        if anchor_state.hash_tree_root() != state_root:
            raise ValueError(
                "checkpoint provider served a state that does not match the "
                "finalized block's state root — refusing the anchor"
            )
        log.info(
            "checkpoint sync: anchored at finalized slot %d (%s)",
            int(anchor_block.message.slot), root.hex()[:12],
        )
        return anchor_state, anchor_block

    def build(self) -> "Client":
        anchor_block = None
        types = None
        checkpoint = getattr(self, "_checkpoint_url", None)
        if checkpoint and self._spec is None:
            raise ValueError("checkpoint sync still needs a spec")
        if not checkpoint and (self._spec is None or self._genesis_state is None):
            raise ValueError("builder needs a spec and a genesis state")
        from ..crypto.bls.backends import set_backend

        set_backend(self._bls_backend)  # node assembly selects the device path
        self._configure_device()
        if os.environ.get("LIGHTHOUSE_TPU_DEVICE_SHA") == "1":
            from ..ops.sha256_device import install_device_hash

            install_device_hash(device=self._device)  # bulk Merkle layers on the card
        if checkpoint:
            types = build_types(self._spec.preset)
            self._genesis_state, anchor_block = self._checkpoint_fetch(types)
        if types is None:
            types = build_types(self._spec.preset)

        db = None
        if self._datadir is not None:
            os.makedirs(self._datadir, exist_ok=True)
            from ..store import HotColdDB
            from ..store.lockbox_store import LockboxStore

            db = HotColdDB(
                hot=LockboxStore(os.path.join(self._datadir, "chain.db")),
                types=types,
                spec=self._spec,
            )

        execution_engine = None
        if self._el_url is not None:
            from ..execution_layer import ExecutionLayer

            execution_engine = ExecutionLayer(url=self._el_url, jwt_secret=self._el_jwt)

        t = time.perf_counter()
        self._genesis_state.hash_tree_root()
        root_s = time.perf_counter() - t
        t = time.perf_counter()
        chain = BeaconChain(
            genesis_state=self._genesis_state,
            types=types,
            spec=self._spec,
            db=db,
            slot_clock=SystemTimeSlotClock(
                int(self._genesis_state.genesis_time), self._spec.seconds_per_slot
            ),
            execution_engine=execution_engine,
            kzg=self._kzg,
            anchor_block=anchor_block,
        )
        log.info("anchor state at slot %d: its root in %.2f s, the chain (store "
                 "write, fork-choice anchor) in %.2f s", int(self._genesis_state.slot),
                 root_s, time.perf_counter() - t)
        processor = BeaconProcessor(max_workers=self._max_workers)
        slasher = None
        if self._slasher:
            from ..slasher import Slasher, SlasherConfig

            slasher = Slasher(
                types,
                SlasherConfig(slots_per_epoch=self._spec.slots_per_epoch),
                # durable history on the node's lockbox store (reference:
                # SlasherDB over LMDB) — a restart still holds every recorded
                # attestation within the history window; memory-only without
                # a datadir
                store=db.hot if db is not None else None,
            )
        http_server = None
        if self._http_port is not None:
            from ..http_api import HttpApiServer

            http_server = HttpApiServer(chain, processor=processor, port=self._http_port)
        network_node = None
        if getattr(self, "_net_listen", None) is not None:
            from ..network.node import LocalNode
            from ..network.tcp_transport import TcpEndpoint
            import secrets as _secrets

            host, port = self._net_listen
            endpoint_obj = TcpEndpoint(
                f"bn-{_secrets.token_hex(4)}", host=host, port=port
            )
            network_node = LocalNode(
                peer_id=endpoint_obj.peer_id, chain=chain, endpoint=endpoint_obj,
            )
        monitoring = None
        if getattr(self, "_monitoring_endpoint", None):
            from ..monitoring import MonitoringService

            monitoring = MonitoringService(
                endpoint=self._monitoring_endpoint, chain=chain,
                update_period=getattr(self, "_monitoring_period", 60.0),
            )
        if http_server is not None and network_node is not None:
            # VC subnet subscriptions reach the subnet service through the
            # API (reference: http_api -> validator_subscriptions channel),
            # and API-published objects gossip out through the node
            # (reference publish_blocks.rs: gossip first, then self-import)
            http_server.subnet_service = network_node.subnets
            http_server.publish_block_fn = network_node.publish_block
            http_server.publish_attestation_fn = network_node.publish_attestation
            http_server.publish_operation_fn = network_node.publish_operation
            # The node routes read the network's peers and identity (the JAX
            # package's builder leaves both unset: its /eth/v1/node/peer_count
            # answers 0 whatever the node is connected to).
            http_server.peer_manager = network_node.service.peer_manager
            http_server.peer_id = network_node.peer_id
        client = Client(
            chain=chain, processor=processor, http_server=http_server,
            slasher=slasher, monitoring=monitoring, network_node=network_node,
        )
        client._static_peers = list(getattr(self, "_net_peers", []))
        client._boot_nodes = list(getattr(self, "_net_boot_nodes", []))
        return client


class Client:
    """The assembled node: owns the service threads and their shutdown
    (task_executor semantics — every service stops on ``stop()``)."""

    def __init__(self, *, chain, processor, http_server=None, slasher=None,
                 monitoring=None, network_node=None):
        self.chain = chain
        self.processor = processor
        self.http_server = http_server
        self.slasher = slasher
        self.monitoring = monitoring
        self.network_node = network_node
        self._static_peers: List[str] = []
        self._boot_nodes: List[str] = []
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "Client":
        if self.http_server is not None:
            self.http_server.start()
        if self.monitoring is not None:
            self.monitoring.start()
        if self.network_node is not None:
            for addr in self._static_peers + self._boot_nodes:
                try:
                    h, _, p = addr.rpartition(":")
                    self.network_node.endpoint.dial(h, int(p), timeout=5.0)
                except Exception as e:
                    log.warning("dial %s failed: %s", addr, e)
            try:
                n = self.network_node.discover_peers()
                if n:
                    log.info("discovered %d peers", n)
            except Exception as e:
                log.warning("peer discovery failed: %s", e)
            if self.chain.anchor_slot > 0:
                # checkpoint boot: fill history behind the anchor off the
                # hot path (reference: backfill runs as a background sync)
                t = threading.Thread(
                    target=self._run_backfill, name="backfill", daemon=True
                )
                t.start()
                self._threads.append(t)
        timer = threading.Thread(target=self._slot_timer, name="slot-timer", daemon=True)
        timer.start()
        self._threads.append(timer)
        return self

    def _run_backfill(self) -> None:
        from ..network.backfill import BackfillSync

        backfill = BackfillSync(chain=self.chain, service=self.network_node.service)
        while not self._shutdown.is_set() and not backfill.complete:
            peers = list(self.network_node.endpoint.connected_peers())
            progressed = 0
            for peer in peers:
                try:
                    # a batch that fails on `peer` retries once against the
                    # next connected peer instead of ending the round
                    progressed += backfill.backfill_from(
                        peer, fallback_peers=[p for p in peers if p != peer])
                except Exception as e:
                    log.warning("backfill from %s failed: %s", peer, e)
                if backfill.complete:
                    break
            if backfill.complete:
                log.info("backfill complete: %d blocks", backfill.blocks_filled)
                return
            if not progressed:
                # nothing served this round: wait for more/better peers
                self._shutdown.wait(timeout=12.0)

    def _slot_timer(self) -> None:
        """Per-slot tick + notifier line (reference ``timer`` crate +
        ``notifier.rs``)."""
        clock = self.chain.slot_clock
        sps = self.chain.spec.seconds_per_slot
        while not self._shutdown.is_set():
            wait = clock.duration_to_next_slot()
            if wait is None:
                wait = sps
            # tail-of-slot: pre-advance the head state for the NEXT slot
            # (reference state_advance_timer fires at 3/4 of the slot)
            head_wait = max(0.0, wait - sps / 4)
            if self._shutdown.wait(timeout=head_wait + 0.01):
                return
            slot_before = self.chain.current_slot()
            try:
                self.chain.prepare_next_slot()
            except Exception as e:
                log.warning("state pre-advance failed: %s", e)
            if self.chain.current_slot() == slot_before:
                # normal case: the advance finished inside the slot — wait
                # out the remainder.  If it OVERRAN the boundary, fall
                # through and tick immediately (the new slot must not lose
                # its head recompute/pruning to a full-slot sleep).
                remaining = clock.duration_to_next_slot()
                if remaining is None:
                    remaining = sps - head_wait  # pre-genesis: keep 1 tick/slot
                if self._shutdown.wait(timeout=remaining + 0.05):
                    return
            try:
                self.chain.per_slot_task()
                node = self.network_node
                if node is not None and getattr(node, "subnets", None) is not None:
                    slot = self.chain.current_slot()
                    node.subnets.prune(slot)
                    node.subnets.update_epoch(
                        slot // self.chain.spec.slots_per_epoch)
                    node.refresh_subnet_advertisement()
                self._notify()
            except Exception as e:  # a tick must never kill the timer
                log.warning("per-slot task failed: %s", e)

    def _notify(self) -> None:
        chain = self.chain
        slot = chain.current_slot()
        head_slot = chain.head_slot()
        f_epoch, _ = chain.finalized_checkpoint()
        distance = max(0, slot - head_slot)
        status = "synced" if distance <= 1 else f"behind ({distance} slots)"
        log.info(
            "slot %d | head %s at slot %d | finalized epoch %d | %s",
            slot, chain.head_root.hex()[:10], head_slot, f_epoch, status,
        )
        # Fork-readiness watcher (reference notifier.rs *_readiness blocks):
        # logs ready / NOT-ready inside the pre-fork window.
        from ..chain.fork_readiness import fork_readiness

        try:
            fork_readiness(chain)
        except Exception:
            pass  # a readiness probe must never kill the notifier

    def stop(self) -> None:
        self._shutdown.set()
        if self.network_node is not None:
            try:
                self.network_node.shutdown()
            except Exception:
                pass
        if self.monitoring is not None:
            self.monitoring.stop()
        if self.http_server is not None:
            self.http_server.stop()
        self.processor.shutdown()
        # Drain the device pipeline AFTER the processor stops feeding it:
        # pending futures resolve (no caller hangs), then its threads exit.
        from .. import device_pipeline

        device_pipeline.shutdown()
        for t in self._threads:
            t.join(timeout=2.0)
        if self.chain.db is not None:
            try:
                self.chain.db.close()
            except AttributeError:
                pass
