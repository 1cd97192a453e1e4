"""Process + machine health collection from /proc.

Equivalent of the reference's ``common/system_health`` (256 LoC): the
``ProcessHealth``/``SystemHealth`` observations feeding the
``/lighthouse/health`` + ``/lighthouse/ui/health`` endpoints and the
remote-monitoring payloads (``common/monitoring_api/src/types.rs:64-147``
``ProcessMetrics``/``SystemMetrics`` field sets).

Linux-only data sources (/proc, statvfs) with every read individually
guarded — health collection must never take the node down, so a missing
file yields zeros, not an exception.

A copy of the JAX package's ``lighthouse_tpu/system_health.py``.
"""

from __future__ import annotations

import os
import time
from dataclasses import asdict, dataclass

from . import metrics as _metrics

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


@dataclass
class ProcessHealth:
    """This process (reference ``ProcessHealth`` -> ``ProcessMetrics``)."""

    pid: int = 0
    pid_num_threads: int = 0
    pid_mem_resident_set_size: int = 0  # bytes
    pid_mem_virtual_memory_size: int = 0  # bytes
    pid_process_seconds_total: int = 0  # utime + stime

    @classmethod
    def observe(cls) -> "ProcessHealth":
        h = cls(pid=os.getpid())
        stat = _read("/proc/self/stat")
        if stat:
            # fields after the parenthesised comm (which may contain spaces)
            try:
                rest = stat.rsplit(")", 1)[1].split()
                # rest[0] is state; utime=rest[11], stime=rest[12],
                # num_threads=rest[17], vsize=rest[20], rss=rest[21] (pages)
                h.pid_process_seconds_total = (
                    int(rest[11]) + int(rest[12])) // _CLK_TCK
                h.pid_num_threads = int(rest[17])
                h.pid_mem_virtual_memory_size = int(rest[20])
                h.pid_mem_resident_set_size = int(rest[21]) * _PAGE
            except (IndexError, ValueError):
                pass
        return h


@dataclass
class SystemHealth:
    """The machine (reference ``SystemHealth`` -> ``SystemMetrics``)."""

    cpu_cores: int = 0
    cpu_threads: int = 0
    cpu_time_total: int = 0  # system seconds
    user_seconds_total: int = 0
    iowait_seconds_total: int = 0
    idle_seconds_total: int = 0

    sys_virt_mem_total: int = 0
    sys_virt_mem_free: int = 0
    sys_virt_mem_cached: int = 0
    sys_virt_mem_buffers: int = 0

    disk_node_bytes_total: int = 0
    disk_node_bytes_free: int = 0
    disk_node_reads_total: int = 0
    disk_node_writes_total: int = 0

    network_node_bytes_total_received: int = 0
    network_node_bytes_total_transmit: int = 0

    misc_node_boot_ts_seconds: int = 0
    misc_os: str = "lin"

    @classmethod
    def observe(cls, disk_path: str = "/") -> "SystemHealth":
        h = cls()
        h.cpu_threads = os.cpu_count() or 0
        h.cpu_cores = h.cpu_threads  # /proc gives no reliable core split here

        stat = _read("/proc/stat")
        for line in stat.splitlines():
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "cpu" and len(parts) >= 6:
                try:
                    jiffies = [int(x) for x in parts[1:]]
                    h.user_seconds_total = jiffies[0] // _CLK_TCK
                    h.idle_seconds_total = jiffies[3] // _CLK_TCK
                    h.iowait_seconds_total = jiffies[4] // _CLK_TCK
                    # reference semantics: cpu_time_total is the TOTAL of
                    # every mode (psutil cpu.total()), not system-mode only
                    # — dashboards derive utilization as (total-idle)/total
                    h.cpu_time_total = sum(jiffies) // _CLK_TCK
                except ValueError:
                    pass
            elif parts[0] == "btime" and len(parts) >= 2:
                try:
                    h.misc_node_boot_ts_seconds = int(parts[1])
                except ValueError:
                    pass

        mem = {}
        for line in _read("/proc/meminfo").splitlines():
            bits = line.split()
            if len(bits) >= 2 and bits[0].endswith(":"):
                try:
                    mem[bits[0][:-1]] = int(bits[1]) * 1024
                except ValueError:
                    pass
        h.sys_virt_mem_total = mem.get("MemTotal", 0)
        h.sys_virt_mem_free = mem.get("MemFree", 0)
        h.sys_virt_mem_cached = mem.get("Cached", 0)
        h.sys_virt_mem_buffers = mem.get("Buffers", 0)

        try:
            st = os.statvfs(disk_path)
            h.disk_node_bytes_total = st.f_frsize * st.f_blocks
            h.disk_node_bytes_free = st.f_frsize * st.f_bavail
        except OSError:
            pass

        # Whole devices only: a partition's IOs are already counted by its
        # parent device (sda1 under sda, nvme0n1p1 under nvme0n1) — summing
        # both double-counts every IO.  A name with a proper-prefix sibling
        # is a partition.
        disk_rows = []
        for line in _read("/proc/diskstats").splitlines():
            bits = line.split()
            if len(bits) >= 10 and not bits[2].startswith(("loop", "ram")):
                disk_rows.append(bits)
        names = {bits[2] for bits in disk_rows}

        def _is_partition(name: str) -> bool:
            """Kernel partition naming: a parent ending in a digit gets
            'p<n>' partitions (nvme0n1 -> nvme0n1p1), otherwise bare digits
            (sda -> sda1).  A plain prefix test would also swallow sibling
            devices like dm-10 under dm-1."""
            for parent in names:
                if parent == name or not name.startswith(parent):
                    continue
                suffix = name[len(parent):]
                if parent[-1].isdigit():
                    if suffix[0] == "p" and suffix[1:].isdigit():
                        return True
                elif suffix.isdigit():
                    return True
            return False

        for bits in disk_rows:
            if _is_partition(bits[2]):
                continue
            try:
                h.disk_node_reads_total += int(bits[3])
                h.disk_node_writes_total += int(bits[7])
            except ValueError:
                pass

        for line in _read("/proc/net/dev").splitlines()[2:]:
            if ":" not in line:
                continue
            name, rest = line.split(":", 1)
            if name.strip() == "lo":
                continue
            bits = rest.split()
            if len(bits) >= 9:
                try:
                    h.network_node_bytes_total_received += int(bits[0])
                    h.network_node_bytes_total_transmit += int(bits[8])
                except ValueError:
                    pass
        return h


def observe_all(disk_path: str = "/") -> dict:
    """Both observations as one flat dict (the /lighthouse/health shape)."""
    out = asdict(ProcessHealth.observe())
    out.update(asdict(SystemHealth.observe(disk_path)))
    out["observed_at_ms"] = int(time.time() * 1000)
    return out


# ------------------------------------------------- standard process metrics
# The three series every stock Grafana "process" dashboard expects, sampled
# on scrape via the registry's collector hook.

PROCESS_CPU_SECONDS = _metrics.counter(
    "process_cpu_seconds_total", "Total user and system CPU time of this process"
)
PROCESS_RESIDENT_MEMORY = _metrics.gauge(
    "process_resident_memory_bytes", "Resident memory size of this process"
)
PROCESS_START_TIME = _metrics.gauge(
    "process_start_time_seconds", "Start time of this process since unix epoch"
)


def _process_start_time() -> float:
    """Epoch start time from /proc (starttime ticks since boot + btime);
    falls back to this module's import time."""
    try:
        stat = _read("/proc/self/stat")
        rest = stat.rsplit(")", 1)[1].split()
        start_ticks = int(rest[19])  # starttime: field 22 of /proc/self/stat
        for line in _read("/proc/stat").splitlines():
            if line.startswith("btime"):
                return int(line.split()[1]) + start_ticks / _CLK_TCK
    except (IndexError, ValueError):
        pass
    return _IMPORT_TIME


_IMPORT_TIME = time.time()
_START_TIME = _process_start_time()


def _process_cpu_seconds() -> float:
    """utime+stime as FLOAT seconds — ProcessHealth's integer field would
    make rate(process_cpu_seconds_total[...]) step in whole-second jumps."""
    try:
        rest = _read("/proc/self/stat").rsplit(")", 1)[1].split()
        return (int(rest[11]) + int(rest[12])) / _CLK_TCK
    except (IndexError, ValueError):
        return 0.0


def _collect_process_metrics() -> None:
    h = ProcessHealth.observe()
    PROCESS_CPU_SECONDS.set_total(_process_cpu_seconds())
    PROCESS_RESIDENT_MEMORY.set(float(h.pid_mem_resident_set_size))
    PROCESS_START_TIME.set(_START_TIME)


_metrics.register_collector(_collect_process_metrics)
