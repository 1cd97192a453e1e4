"""Priority work scheduler (reference: ``beacon_node/beacon_processor``).

A copy of the JAX package's ``lighthouse_tpu/scheduler/__init__.py``: the
work taxonomy (``work.py``), the processor (``processor.py``) and the
admission controller (``admission.py``).
"""

from .admission import (
    CLASS_BULK,
    CLASS_CRITICAL,
    CLASS_DUTIES,
    AdmissionController,
    ClassPolicy,
    DropPolicy,
    ShedError,
    SyncDropPolicy,
)
from .processor import BeaconProcessor, ProcessorMetrics, ReprocessQueue
from .work import BATCH_RULES, DRAIN_ORDER, W, WorkEvent

__all__ = [
    "AdmissionController",
    "BATCH_RULES",
    "BeaconProcessor",
    "CLASS_BULK",
    "CLASS_CRITICAL",
    "CLASS_DUTIES",
    "ClassPolicy",
    "DRAIN_ORDER",
    "DropPolicy",
    "ProcessorMetrics",
    "ReprocessQueue",
    "ShedError",
    "SyncDropPolicy",
    "W",
    "WorkEvent",
]
