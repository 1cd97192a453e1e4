"""The validator client: duties-driven attesting, aggregating and proposing
against one or more beacon nodes over the HTTP API, with EIP-3076 slashing
protection vetoing every signature.

Equivalent of the reference's ``validator_client`` crate
(``src/lib.rs`` ``ProductionValidatorClient`` — duties service + attestation
service + block service over ``BeaconNodeHttpClient`` with multi-BN
fallback).  ``run_slot`` is the manual-tick entry the simulator and tests
drive; ``run_forever`` adds the wall-clock pacing (attest at +1/3, aggregate
at +2/3) for a real deployment.

A copy of the JAX package's ``lighthouse_tpu/validator_client/__init__.py``.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from ..crypto.bls import api as bls
from ..http_api.client import BeaconNodeHttpClient
from ..types.spec import ChainSpec
from .services import (
    AttestationService,
    BeaconNodeFallback,
    BlockService,
    DoppelgangerService,
    DutiesService,
    NoViableBeaconNode,
    PreparationService,
    SyncCommitteeService,
)
from .slashing_protection import SlashingProtectionDB, SlashingProtectionError
from .validator_store import ValidatorStore

__all__ = [
    "BeaconNodeFallback",
    "NoViableBeaconNode",
    "SlashingProtectionDB",
    "SlashingProtectionError",
    "ValidatorClient",
    "ValidatorStore",
]


class ValidatorClient:
    def __init__(
        self,
        *,
        keys: List[bls.SecretKey],
        beacon_nodes: List[BeaconNodeHttpClient],
        spec: ChainSpec,
        types,
        genesis_validators_root: bytes,
        slashing_db: Optional[SlashingProtectionDB] = None,
        fake_signatures: bool = False,
        fee_recipient: bytes = b"\x00" * 20,
        graffiti_file_path: Optional[str] = None,
    ):
        self.spec = spec
        self.types = types
        self.store = ValidatorStore(
            keys=keys,
            spec=spec,
            genesis_validators_root=genesis_validators_root,
            slashing_db=slashing_db,
            fake_signatures=fake_signatures,
        )
        self.fallback = BeaconNodeFallback(beacon_nodes)
        self.duties = DutiesService(store=self.store, fallback=self.fallback)
        self.attester = AttestationService(
            store=self.store, duties=self.duties, fallback=self.fallback, types=types
        )
        graffiti_file = None
        if graffiti_file_path is not None:
            from .graffiti_file import GraffitiFile

            graffiti_file = GraffitiFile(graffiti_file_path)
        self.blocks = BlockService(
            store=self.store, duties=self.duties, fallback=self.fallback,
            types=types, graffiti_file=graffiti_file,
        )
        self.sync_committee = SyncCommitteeService(
            store=self.store, duties=self.duties, fallback=self.fallback, types=types
        )
        self.preparation = PreparationService(
            store=self.store, duties=self.duties, fallback=self.fallback,
            fee_recipient=fee_recipient,
        )
        self.doppelganger: Optional[DoppelgangerService] = None
        self._last_duties_epoch: Optional[int] = None
        self.latencies: List[dict] = []  # last per-BN RTT measurements
        self._latency_slot = -1  # slot of the freshest completed probe
        self._latency_lock = threading.Lock()

    def enable_doppelganger_protection(self, start_epoch: int) -> None:
        """Block ALL signing until liveness checks prove no other instance is
        running our keys (reference ``doppelganger_service.rs``)."""
        self.doppelganger = DoppelgangerService(
            store=self.store, duties=self.duties, fallback=self.fallback,
            start_epoch=start_epoch,
        )

    # ------------------------------------------------------------ manual

    def update_duties(self, epoch: int) -> None:
        self.duties.update(epoch)
        self._last_duties_epoch = epoch

    def run_slot(self, slot: int) -> dict:
        """One full slot of validator work, in protocol order: propose at
        slot start, attest (+1/3), aggregate (+2/3).  Duties refresh on epoch
        change.  Returns a summary dict (the notifier line)."""
        epoch = slot // self.spec.slots_per_epoch
        if self._last_duties_epoch != epoch:
            self.update_duties(epoch)
            if self.doppelganger is not None:
                self.doppelganger.check(epoch)
            try:
                self.preparation.prepare()
            except NoViableBeaconNode:
                pass  # preparations are best-effort; retried next epoch
        if not self.store.signing_enabled:
            # Doppelganger gate down: perform NO duties (the whole point),
            # but keep polling duties/liveness above.
            return {
                "slot": slot, "proposed": None, "attestations": 0,
                "aggregates": 0, "sync_messages": 0, "sync_contributions": 0,
                "doppelganger_blocked": True,
            }
        proposed = self.blocks.propose(slot)
        attested = self.attester.attest(slot)
        sync_messages = self.sync_committee.produce_messages(slot)
        aggregated = self.attester.aggregate(slot)
        sync_contributions = self.sync_committee.aggregate(slot)
        return {
            "slot": slot,
            "proposed": proposed.hex() if proposed else None,
            "attestations": attested,
            "aggregates": aggregated,
            "sync_messages": sync_messages,
            "sync_contributions": sync_contributions,
        }

    # ---------------------------------------------------------- real time

    def run_forever(self, *, genesis_time: int, stop_after_slots: Optional[int] = None):
        """Wall-clock loop: propose at slot start, attest at +1/3, aggregate
        at +2/3 (the reference's slot-timing contract)."""
        from ..logs import get_logger

        log = get_logger("vc")
        sps = self.spec.seconds_per_slot

        def safely(what, fn, *args):
            # One failed duty (BN restart, slashing veto, ...) must never
            # kill the loop — log and carry on to the next phase/slot.
            try:
                return fn(*args)
            except Exception as e:
                log.warning("%s failed at slot task: %s", what, e)
                return None

        done = 0
        while stop_after_slots is None or done < stop_after_slots:
            now = time.time()
            slot = max(0, int((now - genesis_time) // sps))
            slot_start = genesis_time + slot * sps
            epoch = slot // self.spec.slots_per_epoch
            if self._last_duties_epoch != epoch:
                safely("duties update", self.update_duties, epoch)
                if self.doppelganger is not None:
                    safely("doppelganger check", self.doppelganger.check, epoch)
                safely("proposer preparation", self.preparation.prepare)
            if not self.store.signing_enabled:
                # doppelganger gate down: no duties at all — running them
                # would even pollute the slashing DB with roots that were
                # never signed (check_and_insert precedes the signing gate)
                time.sleep(max(0.0, slot_start + sps - time.time()))
                done += 1
                continue
            safely("propose", self.blocks.propose, slot)
            time.sleep(max(0.0, slot_start + sps / 3 - time.time()))
            safely("attest", self.attester.attest, slot)
            safely("sync messages", self.sync_committee.produce_messages, slot)
            time.sleep(max(0.0, slot_start + 2 * sps / 3 - time.time()))
            safely("aggregate", self.attester.aggregate, slot)
            safely("sync contributions", self.sync_committee.aggregate, slot)
            # 11/12ths through the slot: measure per-BN latency (reference
            # latency.rs SLOT_DELAY_MULTIPLIER/DENOMINATOR) — duty traffic
            # is done by now, so the probe reads steady-state RTT.  The
            # measurement runs OFF the duty path (a blackholed BN's probe
            # blocks ~10 s; serialized in-loop it would push every later
            # duty past its deadline — the exact failure it exists to see).
            time.sleep(max(0.0, slot_start + sps * 11 / 12 - time.time()))
            probe_slot = slot

            def _measure(my_slot=probe_slot):
                out = safely("latency measurement",
                             self.fallback.measure_latency) or []
                # a slow probe finishing AFTER a later slot's probe must not
                # overwrite the fresher result (blackholed-BN threads can
                # outlive their slot); compare-and-set under the lock —
                # unlocked, two finishing threads can interleave the check
                # and the writes and reintroduce exactly this bug
                with self._latency_lock:
                    if my_slot >= self._latency_slot:
                        self._latency_slot = my_slot
                        self.latencies = out
                for m in out:
                    if m["latency"] is not None:
                        log.info("beacon node latency", endpoint=m["endpoint"],
                                 ms=round(m["latency"] * 1000, 1))

            threading.Thread(target=_measure, name="vc-latency",
                             daemon=True).start()
            time.sleep(max(0.0, slot_start + sps - time.time()))
            done += 1
