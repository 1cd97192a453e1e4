"""Engine connection state machine: offline → online, with automatic
re-upcheck.

Equivalent of the reference's ``execution_layer/src/engines.rs`` (``Engine``
+ ``State::{Online,Offline,Syncing,AuthFailed}``): every request funnels
through ``request()``, which upchecks an offline engine first and flips the
state on connection errors so callers get fast-fail behavior plus automatic
recovery when the EL comes back.

A copy of the JAX package's ``lighthouse_tpu/execution_layer/engines.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, TypeVar

from .engine_api import EngineApiClient, EngineApiError, EngineOffline

T = TypeVar("T")

STATE_ONLINE = "online"
STATE_OFFLINE = "offline"
STATE_AUTH_FAILED = "auth_failed"


class Engine:
    def __init__(self, api: EngineApiClient, upcheck_cooldown: float = 1.0):
        self.api = api
        self.state = STATE_OFFLINE
        self.capabilities: List[str] = []
        self._lock = threading.Lock()
        self._last_upcheck = 0.0
        self._cooldown = upcheck_cooldown

    def upcheck(self) -> bool:
        """engine_exchangeCapabilities as the health probe (engines.rs
        ``Engine::upcheck``)."""
        with self._lock:
            now = time.monotonic()
            if self.state == STATE_ONLINE:
                return True
            if now - self._last_upcheck < self._cooldown:
                return False
            self._last_upcheck = now
        try:
            caps = self.api.exchange_capabilities()
        except EngineOffline:
            self.state = STATE_OFFLINE
            return False
        except EngineApiError as e:
            self.state = STATE_AUTH_FAILED if "auth" in str(e).lower() else STATE_OFFLINE
            return False
        self.capabilities = caps or []
        self.state = STATE_ONLINE
        return True

    def request(self, fn: Callable[[EngineApiClient], T]) -> T:
        """Run ``fn`` against the API; offline engines are upchecked first,
        and connection failures flip the state back to offline."""
        if self.state != STATE_ONLINE and not self.upcheck():
            raise EngineOffline(f"engine {self.api.url} is {self.state}")
        from .. import fault_injection

        if fault_injection.ACTIVE:
            try:
                fault_injection.check("engine.request")
            except fault_injection.InjectedFault as e:
                # An injected fault plays a dropped connection: the engine
                # flips offline and recovers through the normal
                # upcheck/cooldown machinery.
                self.state = STATE_OFFLINE
                raise EngineOffline(f"engine {self.api.url}: {e}") from e
        try:
            return fn(self.api)
        except EngineOffline:
            self.state = STATE_OFFLINE
            raise
