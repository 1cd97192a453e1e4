"""Token-bucket RPC rate limiter.

Equivalent of the reference's ``rpc/rate_limiter.rs`` (1–495): one quota per
protocol, enforced per peer.  A quota of ``(max_tokens, period)`` replenishes
continuously at ``max_tokens / period`` tokens per second up to the cap;
requests carry a cost (1 for fixed-size requests, the block/root/blob count
for range-style requests, exactly like the reference's
``RPCRequest::expected_responses``).  A request whose cost exceeds the
bucket's CAP can never be served and is a protocol violation; one that only
exceeds the current fill is throttled.

A copy of the JAX package's ``lighthouse_tpu/network/rate_limiter.py``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from . import rpc as rpc_mod


@dataclass(frozen=True)
class Quota:
    max_tokens: float
    period_secs: float


# Mirrors the reference's default RPC quotas (rate_limiter.rs defaults /
# lighthouse_network config): generous enough for honest sync, tight enough
# that a single peer cannot monopolize the worker pool.
DEFAULT_QUOTAS: Dict[str, Quota] = {
    rpc_mod.STATUS: Quota(5, 15.0),
    rpc_mod.GOODBYE: Quota(1, 10.0),
    rpc_mod.PING: Quota(2, 10.0),
    rpc_mod.METADATA: Quota(2, 5.0),
    rpc_mod.BLOCKS_BY_RANGE: Quota(1024, 10.0),  # tokens are BLOCKS
    rpc_mod.BLOCKS_BY_ROOT: Quota(128, 10.0),  # tokens are ROOTS
    rpc_mod.BLOBS_BY_RANGE: Quota(768, 10.0),
    rpc_mod.BLOBS_BY_ROOT: Quota(128, 10.0),
    # light-client serving does per-request state reads (bootstrap walks
    # Merkle branches) — quota it like the reference does
    rpc_mod.LIGHT_CLIENT_BOOTSTRAP: Quota(1, 10.0),
    rpc_mod.LIGHT_CLIENT_OPTIMISTIC_UPDATE: Quota(1, 10.0),
    rpc_mod.LIGHT_CLIENT_FINALITY_UPDATE: Quota(1, 10.0),
}


def request_cost(protocol: str, request) -> float:
    """Token cost of one request (the reference's expected_responses)."""
    if protocol == rpc_mod.BLOCKS_BY_RANGE or protocol == rpc_mod.BLOBS_BY_RANGE:
        return max(1, int(getattr(request, "count", 1)))
    if protocol == rpc_mod.BLOCKS_BY_ROOT:
        return max(1, len(getattr(request, "roots", ()) or ()))
    if protocol == rpc_mod.BLOBS_BY_ROOT:
        return max(1, len(getattr(request, "ids", ()) or ()))
    return 1.0


class RateLimitExceeded(Exception):
    def __init__(self, fatal: bool):
        self.fatal = fatal  # cost can NEVER fit (protocol violation)
        super().__init__("rate limit exceeded" + (" (oversize request)" if fatal else ""))


class RPCRateLimiter:
    def __init__(self, quotas: Optional[Dict[str, Quota]] = None,
                 clock=time.monotonic):
        self.quotas = dict(DEFAULT_QUOTAS if quotas is None else quotas)
        self._clock = clock
        self._lock = threading.Lock()
        # (peer, protocol) -> (tokens, last_refill_time)
        self._buckets: Dict[Tuple[str, str], Tuple[float, float]] = {}

    def allow(self, peer: str, protocol: str, cost: float = 1.0) -> None:
        """Consume ``cost`` tokens or raise ``RateLimitExceeded``.

        Unknown protocols are unlimited (the router rejects them anyway)."""
        quota = self.quotas.get(protocol)
        if quota is None:
            return
        if cost > quota.max_tokens:
            raise RateLimitExceeded(fatal=True)
        now = self._clock()
        with self._lock:
            tokens, last = self._buckets.get((peer, protocol),
                                             (quota.max_tokens, now))
            tokens = min(
                quota.max_tokens,
                tokens + (now - last) * quota.max_tokens / quota.period_secs,
            )
            if tokens < cost:
                self._buckets[(peer, protocol)] = (tokens, now)
                raise RateLimitExceeded(fatal=False)
            self._buckets[(peer, protocol)] = (tokens - cost, now)

    def prune(self, older_than_secs: float = 120.0) -> None:
        """Drop idle buckets (bounded memory under peer churn)."""
        cutoff = self._clock() - older_than_secs
        with self._lock:
            self._buckets = {
                k: v for k, v in self._buckets.items() if v[1] >= cutoff
            }
