"""Chain core: BeaconChain, harness, clocks, mock execution engine
(reference: ``beacon_node/beacon_chain`` + ``common/slot_clock`` +
``execution_layer/test_utils``).

A copy of the JAX package's ``lighthouse_tpu/chain/__init__.py``.
"""

from .beacon_chain import (
    AttestationError,
    BeaconChain,
    BlockError,
    ChainError,
    NaiveAggregationPool,
    genesis_block_root_of,
)
from .harness import BeaconChainHarness
from .mock_el import MockExecutionEngine
from .slot_clock import ManualSlotClock, SlotClock, SystemTimeSlotClock

__all__ = [
    "AttestationError",
    "BeaconChain",
    "BeaconChainHarness",
    "BlockError",
    "ChainError",
    "ManualSlotClock",
    "MockExecutionEngine",
    "NaiveAggregationPool",
    "SlotClock",
    "SystemTimeSlotClock",
    "genesis_block_root_of",
]
