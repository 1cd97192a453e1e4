"""Peer database + scoring + ban lifecycle.

Equivalent of the reference's ``peer_manager/`` + ``peerdb/score.rs``: a
real-valued score per peer combining protocol penalties, decaying toward
zero, with disconnect/ban thresholds.  Numbers mirror the reference's
(`peerdb/score.rs`: MIN_SCORE_BEFORE_DISCONNECT = -20,
MIN_SCORE_BEFORE_BAN = -50, halflife-driven decay).

A copy of the JAX package's ``lighthouse_tpu/network/peer_manager.py``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..logs import get_logger

log = get_logger("network.peers")

MIN_SCORE_BEFORE_DISCONNECT = -20.0
MIN_SCORE_BEFORE_BAN = -50.0
SCORE_HALFLIFE_SECS = 600.0
BANNED_BEFORE_DECAY_SECS = 1800.0
DEFAULT_TARGET_PEERS = 16


class PeerAction:
    """Reference ``PeerAction`` severity ladder."""

    FATAL = "fatal"  # instant ban
    LOW_TOLERANCE = "low"  # -10: ban after ~5
    MID_TOLERANCE = "mid"  # -5
    HIGH_TOLERANCE = "high"  # -1

    PENALTIES = {FATAL: -100.0, LOW_TOLERANCE: -10.0, MID_TOLERANCE: -5.0, HIGH_TOLERANCE: -1.0}


class ConnectionState:
    CONNECTED = "connected"
    DISCONNECTED = "disconnected"
    BANNED = "banned"


@dataclass
class PeerInfo:
    peer_id: str
    state: str = ConnectionState.DISCONNECTED
    score: float = 0.0
    last_update: float = field(default_factory=time.monotonic)
    banned_at: Optional[float] = None
    metadata: Optional[object] = None
    status: Optional[object] = None  # last Status handshake

    def decayed_score(self, now: float) -> float:
        dt = max(0.0, now - self.last_update)
        if self.banned_at is not None and now - self.banned_at < BANNED_BEFORE_DECAY_SECS:
            return self.score  # banned scores freeze before decaying
        return self.score * math.exp(-dt * math.log(2) / SCORE_HALFLIFE_SECS)


class PeerManager:
    def __init__(self, target_peers: int = DEFAULT_TARGET_PEERS,
                 clock=time.monotonic):
        # Injectable clock (same seam as RateLimiter): score decay and ban
        # lifts are control-path time — a scenario/virtual-time harness
        # supplies its own clock so decay cannot race thresholds against
        # host load.
        self.peers: Dict[str, PeerInfo] = {}
        self.target_peers = target_peers
        self._clock = clock
        self._disconnect_requests: List[str] = []

    def _peer(self, peer_id: str) -> PeerInfo:
        info = self.peers.get(peer_id)
        if info is None:
            info = self.peers[peer_id] = PeerInfo(
                peer_id, last_update=self._clock())
        return info

    # --------------------------------------------------------- lifecycle

    def on_connect(self, peer_id: str) -> bool:
        """Returns False when the peer is banned and must be refused."""
        info = self._peer(peer_id)
        if self.is_banned(peer_id):
            log.debug("refused banned peer", peer=peer_id)
            return False
        info.state = ConnectionState.CONNECTED
        log.info("peer connected", peer=peer_id,
                 connected=len(self.connected_peers()))
        return True

    def on_disconnect(self, peer_id: str) -> None:
        info = self._peer(peer_id)
        if info.state != ConnectionState.BANNED:
            info.state = ConnectionState.DISCONNECTED
            log.info("peer disconnected", peer=peer_id,
                     connected=len(self.connected_peers()))

    # ----------------------------------------------------------- scoring

    def report(self, peer_id: str, action: str, _reason: str = "") -> None:
        """Apply a penalty (reference ``report_peer``)."""
        now = self._clock()
        info = self._peer(peer_id)
        info.score = info.decayed_score(now) + PeerAction.PENALTIES[action]
        info.last_update = now
        # epsilon absorbs sub-second decay so "5 low-tolerance strikes ban"
        # holds exactly, as in the reference's threshold arithmetic
        if info.score <= MIN_SCORE_BEFORE_BAN + 1e-3:
            info.score = min(info.score, MIN_SCORE_BEFORE_BAN)
            info.state = ConnectionState.BANNED
            info.banned_at = now
            log.warning("peer banned", peer=peer_id, action=action,
                        score=round(info.score, 1), reason=_reason)
        elif info.score <= MIN_SCORE_BEFORE_DISCONNECT:
            if info.state == ConnectionState.CONNECTED:
                info.state = ConnectionState.DISCONNECTED
                self._disconnect_requests.append(peer_id)

    def score(self, peer_id: str) -> float:
        info = self.peers.get(peer_id)
        return info.decayed_score(self._clock()) if info else 0.0

    def is_banned(self, peer_id: str) -> bool:
        info = self.peers.get(peer_id)
        if info is None:
            return False
        if info.state != ConnectionState.BANNED:
            return False
        # bans lift once the decayed score recovers past the ban threshold
        if info.decayed_score(self._clock()) > MIN_SCORE_BEFORE_BAN:
            info.state = ConnectionState.DISCONNECTED
            info.banned_at = None
            return False
        return True

    def heartbeat(self) -> List[str]:
        """Periodic maintenance; returns peers to disconnect
        (reference ``PeerManager::heartbeat``)."""
        out, self._disconnect_requests = self._disconnect_requests, []
        return out

    # ----------------------------------------------------------- queries

    def connected_peers(self) -> List[str]:
        return [p for p, i in self.peers.items() if i.state == ConnectionState.CONNECTED]

    def best_peer_by_head(self) -> Optional[str]:
        """Connected peer with the highest advertised head slot."""
        best, best_slot = None, -1
        for pid in self.connected_peers():
            st = self.peers[pid].status
            if st is not None and st.head_slot > best_slot:
                best, best_slot = pid, st.head_slot
        return best
