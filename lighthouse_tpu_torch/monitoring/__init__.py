"""Remote monitoring push service.

Equivalent of the reference's ``common/monitoring_api`` (605 LoC;
``src/lib.rs:18-19`` — POST process/beacon-node stats to a beaconcha.in-style
client-stats endpoint every 60 s).

A copy of the JAX package's ``lighthouse_tpu/monitoring/__init__.py``, on
the port's ``metrics`` and ``system_health``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Callable, Optional

from .. import metrics

DEFAULT_UPDATE_PERIOD_SECS = 60.0
CLIENT_NAME = "lighthouse-tpu"


from .. import __version__ as CLIENT_VERSION


def _common_process_metrics() -> dict:
    """The reference's ``ProcessMetrics`` common block
    (monitoring_api/src/types.rs:64-70), shared by every process payload."""
    from ..system_health import ProcessHealth

    ph = ProcessHealth.observe()
    return {
        "cpu_process_seconds_total": ph.pid_process_seconds_total,
        "memory_process_bytes": ph.pid_mem_resident_set_size,
        "client_name": CLIENT_NAME,
        "client_version": CLIENT_VERSION,
        "client_build": 0,
    }


def collect_beacon_stats(chain) -> dict:
    """The beaconcha.in client-stats "beaconnode" process payload
    (reference ``BeaconProcessMetrics``: common block + beacon values)."""
    f_epoch, _ = chain.finalized_checkpoint()
    head_slot = chain.head_slot()
    out = {
        "version": 1,
        "timestamp": int(time.time() * 1000),
        "process": "beaconnode",
        "sync_beacon_head_slot": int(head_slot),
        "sync_eth2_synced": True,
        "slasher_active": False,
        "finalized_epoch": int(f_epoch),
        "signature_sets_verified": int(metrics.SIGNATURE_SETS_VERIFIED.get()),
        "device_batches": int(metrics.DEVICE_BATCH_INVOCATIONS.get()),
    }
    out.update(_common_process_metrics())
    return out


def collect_validator_stats(vc) -> dict:
    """The "validator" process payload (reference
    ``ValidatorProcessMetrics``): duty outcomes + the common block."""
    total = len(getattr(vc, "validators", ()) or ())
    # "active" = allowed to sign: the doppelganger gate zeroes it while
    # liveness checks run (reference gathers validator_active from its own
    # metric, monitoring_api/src/gather.rs)
    store = getattr(vc, "store", None)
    signing = getattr(store, "signing_enabled",
                      getattr(vc, "signing_enabled", True))
    out = {
        "version": 1,
        "timestamp": int(time.time() * 1000),
        "process": "validator",
        "validator_total": total,
        "validator_active": total if signing else 0,
    }
    out.update(_common_process_metrics())
    return out


def collect_system_stats(_chain=None) -> dict:
    """The "system" machine payload (reference ``SystemMetrics``,
    monitoring_api/src/types.rs:87-147 field names)."""
    from ..system_health import SystemHealth

    h = SystemHealth.observe()
    return {
        "version": 1,
        "timestamp": int(time.time() * 1000),
        "process": "system",
        "cpu_cores": h.cpu_cores,
        "cpu_threads": h.cpu_threads,
        "cpu_node_system_seconds_total": h.cpu_time_total,
        "cpu_node_user_seconds_total": h.user_seconds_total,
        "cpu_node_iowait_seconds_total": h.iowait_seconds_total,
        "cpu_node_idle_seconds_total": h.idle_seconds_total,
        "memory_node_bytes_total": h.sys_virt_mem_total,
        "memory_node_bytes_free": h.sys_virt_mem_free,
        "memory_node_bytes_cached": h.sys_virt_mem_cached,
        "memory_node_bytes_buffers": h.sys_virt_mem_buffers,
        "disk_node_bytes_total": h.disk_node_bytes_total,
        "disk_node_bytes_free": h.disk_node_bytes_free,
        "disk_node_io_seconds": 0,
        "disk_node_reads_total": h.disk_node_reads_total,
        "disk_node_writes_total": h.disk_node_writes_total,
        "network_node_bytes_total_receive": h.network_node_bytes_total_received,
        "network_node_bytes_total_transmit": h.network_node_bytes_total_transmit,
        "misc_node_boot_ts_seconds": h.misc_node_boot_ts_seconds,
        "misc_os": h.misc_os,
    }


class MonitoringService:
    """Periodic POST of node stats to ``endpoint`` (the reference's
    ``monitoring-endpoint`` flag)."""

    def __init__(self, *, endpoint: str, chain,
                 update_period: float = DEFAULT_UPDATE_PERIOD_SECS,
                 collector: Optional[Callable[[object], dict]] = None,
                 send_system: bool = True):
        self.endpoint = endpoint.rstrip("/")
        self.chain = chain
        self.update_period = update_period
        self.collector = collector or collect_beacon_stats
        self.send_system = send_system
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[str] = None
        self.sends = 0

    def send_once(self) -> bool:
        # One POST carries every process payload (reference send_metrics
        # posts the list of requested ProcessTypes in a single body).
        payloads = [self.collector(self.chain)]
        if self.send_system:
            payloads.append(collect_system_stats())
        body = json.dumps(payloads).encode()
        req = urllib.request.Request(
            self.endpoint, data=body, method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=5.0):
                pass
            self.sends += 1
            self.last_error = None
            return True
        except OSError as e:
            # monitoring must never hurt the node: record and carry on
            self.last_error = str(e)
            return False

    def start(self) -> "MonitoringService":
        def loop():
            while not self._stop.wait(self.update_period):
                self.send_once()

        self._thread = threading.Thread(target=loop, name="monitoring", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
