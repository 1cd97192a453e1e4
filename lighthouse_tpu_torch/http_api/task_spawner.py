"""Dispatch beacon-API handlers through the priority scheduler.

Equivalent of the reference's ``beacon_node/http_api/src/task_spawner.rs``:
every route runs as ``Priority::P0`` (validator-critical), duties, or ``P1``
work on the ``BeaconProcessor``, so API load contends with gossip under the
same drain order instead of starving block import.

On top of the processor's queues sits the admission layer
(``scheduler/admission.py``): each request is classified
(``critical`` > ``duties`` > ``bulk``), counted against a bounded per-class
inflight budget at ingress (immediate 503 past the bound), and shed at
dequeue when it waited past its class deadline — an answer delivered after
the client's own timeout is pure waste, and computing it anyway is how an
overload becomes a collapse.

A copy of the JAX package's ``lighthouse_tpu/http_api/task_spawner.py``,
but for the handler timeout's default: ``LIGHTHOUSE_TPU_API_TIMEOUT_S``
(30 s when unset, the JAX package's fixed default) lets a node started
from the command line serve the routes that copy a mainnet-width state
(the op pools, the next epoch's duties: 20 s and more a copy at 2^20
validators), which the CLI has no flag for.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Optional

from ..scheduler import BeaconProcessor
from ..scheduler.admission import (
    CLASS_BULK,
    CLASS_CRITICAL,
    CLASS_DUTIES,
    AdmissionController,
    ShedError,
)
from ..scheduler.work import W, WorkEvent

P0 = W.API_REQUEST_P0
PD = W.API_REQUEST_DUTIES
P1 = W.API_REQUEST_P1

#: processor priority -> default admission class (routes may override)
DEFAULT_CLASS = {
    P0: CLASS_CRITICAL,
    PD: CLASS_DUTIES,
    P1: CLASS_BULK,
}


class TaskSpawner:
    def __init__(
        self,
        processor: Optional[BeaconProcessor],
        timeout: Optional[float] = None,
        admission: Optional[AdmissionController] = None,
    ):
        self.processor = processor
        if timeout is None:
            timeout = float(os.environ.get("LIGHTHOUSE_TPU_API_TIMEOUT_S", "30"))
        self.timeout = timeout
        self.admission = admission if admission is not None else AdmissionController()

    def blocking_json_task(
        self, priority: str, func: Callable[[], Any], klass: Optional[str] = None
    ) -> Any:
        """Run ``func`` on the processor at ``priority`` and block for the
        result (the warp handler's await).  Falls back to inline execution
        when there is no processor (bare-chain servers in tests) — admission
        bounds still apply there (inline threads are a finite resource too).

        Raises :class:`ShedError` when admission sheds the request — at
        ingress (class inflight bound) or at dequeue (class deadline)."""
        klass = klass or DEFAULT_CLASS.get(priority, CLASS_BULK)
        ticket = self.admission.try_admit(klass)  # raises ShedError when full
        if self.processor is None:
            try:
                return func()
            finally:
                ticket.release()
        done = threading.Event()
        box: dict = {}

        def run(_item=None):
            try:
                ticket.check_deadline()  # raises ShedError when stale
                box["result"] = func()
            except BaseException as e:  # propagate to the HTTP thread
                box["error"] = e
            finally:
                ticket.release()
                done.set()

        accepted = self.processor.send(WorkEvent(work_type=priority, process=run))
        if not accepted:
            ticket.release()
            raise OverloadedError("beacon processor queue full")
        if not done.wait(self.timeout):
            raise TimeoutError("beacon processor did not run the API task in time")
        if "error" in box:
            raise box["error"]
        return box.get("result")


class OverloadedError(Exception):
    pass
