"""Fork-readiness watchers.

Equivalent of the reference's
``beacon_node/beacon_chain/src/{capella,deneb,electra}_readiness.rs`` as
surfaced by ``client/src/notifier.rs``: in the run-up to a scheduled fork,
each tick reports whether this node is READY — the EL is reachable and
speaks the fork's engine methods, and (for deneb+) the blob machinery has a
KZG trusted setup loaded — so operators learn about a missing upgrade
BEFORE the fork activates, not at the first missed block.

A copy of the JAX package's ``lighthouse_tpu/chain/fork_readiness.py``.
"""

from __future__ import annotations

from typing import Optional

from ..logs import get_logger

log = get_logger("chain.readiness")

# Start warning this many epochs ahead (reference readiness window).
READINESS_WINDOW_EPOCHS = 2

# Engine methods each fork's payload flow needs (reference *_readiness.rs
# capability checks).
_REQUIRED_ENGINE_METHODS = {
    "bellatrix": ("engine_newPayloadV1", "engine_forkchoiceUpdatedV1",
                  "engine_getPayloadV1"),
    "capella": ("engine_newPayloadV2", "engine_forkchoiceUpdatedV2",
                "engine_getPayloadV2"),
    "deneb": ("engine_newPayloadV3", "engine_forkchoiceUpdatedV3",
              "engine_getPayloadV3"),
    "electra": ("engine_newPayloadV4", "engine_getPayloadV4"),
}

_FORK_EPOCH_ATTR = {
    "altair": "altair_fork_epoch",
    "bellatrix": "bellatrix_fork_epoch",
    "capella": "capella_fork_epoch",
    "deneb": "deneb_fork_epoch",
    "electra": "electra_fork_epoch",
}

_FORK_ORDER = ("phase0", "altair", "bellatrix", "capella", "deneb", "electra")


def next_scheduled_fork(spec, current_epoch: int) -> Optional[tuple]:
    """(fork_name, fork_epoch) of the nearest fork still ahead, or None."""
    best = None
    for name in _FORK_ORDER[1:]:
        epoch = getattr(spec, _FORK_EPOCH_ATTR[name])
        if epoch is not None and epoch > current_epoch:
            if best is None or epoch < best[1]:
                best = (name, epoch)
    return best


def fork_readiness(chain) -> Optional[dict]:
    """Readiness report for the next fork inside the warning window, or
    None when no fork is near.  Shape mirrors the notifier's log fields."""
    spec = chain.spec
    current_epoch = chain.current_slot() // spec.slots_per_epoch
    upcoming = next_scheduled_fork(spec, current_epoch)
    if upcoming is None:
        return None
    fork, fork_epoch = upcoming
    if fork_epoch - current_epoch > READINESS_WINDOW_EPOCHS:
        return None

    problems = []
    engine = chain.execution_engine
    if fork in _REQUIRED_ENGINE_METHODS:
        if engine is None:
            problems.append("no execution engine configured")
        elif hasattr(engine, "engine"):  # real ExecutionLayer facade
            try:
                caps = engine.engine.capabilities or []
            except Exception:
                caps = []
            if not caps:
                problems.append("execution engine unreachable")
            else:
                missing = [m for m in _REQUIRED_ENGINE_METHODS[fork]
                           if m not in caps]
                if missing:
                    problems.append(f"engine missing {','.join(missing)}")
        # in-proc mock engine: structurally fork-complete, nothing to check
    if fork in ("deneb", "electra") and chain.kzg is None:
        problems.append("no KZG trusted setup loaded (blob verification)")

    report = {
        "fork": fork,
        "fork_epoch": int(fork_epoch),
        "current_epoch": int(current_epoch),
        "ready": not problems,
        "problems": problems,
    }
    if problems:
        log.warning("NOT ready for fork", **report)
    else:
        log.info("ready for fork", fork=fork, fork_epoch=int(fork_epoch))
    return report
