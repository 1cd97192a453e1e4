"""The port's in-process hub (``network/transport.py``) and sync hardening
(``network/sync.py``, ``network/backfill.py``) vs the JAX package's.

Here:

- parity: the same seed, link plans, partitions and traffic over both
  packages' ``Hub``s give the same per-link delivery schedule, the same
  ``schedule_digest()``, the same delivered envelopes in the same order and
  the same fault counters;
- the JAX package's ``test_hub_faults.py`` and ``test_sync_hardening.py``
  cases, re-pointed at the port (the hub's ``net.deliver`` point goes
  through the port's ``fault_injection``).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from lighthouse_tpu.network import transport as j_transport  # noqa: E402
from lighthouse_tpu_torch import fault_injection, metrics  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.network import transport  # noqa: E402
from lighthouse_tpu_torch.network.backfill import BackfillSync  # noqa: E402
from lighthouse_tpu_torch.network.node import LocalNode  # noqa: E402
from lighthouse_tpu_torch.network.transport import Envelope, Hub, LinkPlan  # noqa: E402
from test_torch_chain import one_torch_thread, port_cpu  # noqa: E402,F401

GENESIS_TIME = 1_600_000_000


@pytest.fixture(autouse=True)
def _clean_faults():
    fault_injection.reset_for_tests()
    yield
    fault_injection.reset_for_tests()


# ------------------------------------------------------ parity, schedules


def hub_run(mod, seed: int) -> dict:
    """Seeded traffic over ``mod``'s (either package's ``transport``) hub of
    four peers: every link under a random plan (drop, delay, jitter,
    duplicate, reorder, some by kind), partitions formed and healed
    between ticks, one peer unregistered and registered again."""
    rng = np.random.default_rng(seed)
    hub = mod.Hub(seed=seed)
    peers = ["a", "b", "c", "d"]
    eps = {p: hub.register(p) for p in peers}
    for i, p in enumerate(peers):
        for q in peers[i + 1:]:
            hub.connect(p, q)
    hub.record_schedule()
    kinds = ["gossip", "rpc_request", "rpc_response", "ihave"]
    for p in peers:
        for q in peers:
            if p == q:
                continue
            plan = mod.LinkPlan(drop=float(rng.uniform(0, 0.4)), delay=int(rng.integers(0, 3)),
                                jitter=int(rng.integers(0, 3)),
                                duplicate=float(rng.uniform(0, 0.3)),
                                reorder=float(rng.uniform(0, 0.5)))
            hub.set_link_plan(p, q, plan)
            if rng.integers(3) == 0:
                hub.set_link_plan(p, q, mod.LinkPlan(
                    drop=1.0, kinds=frozenset({kinds[int(rng.integers(4))]})))
                hub.set_link_plan(p, q, plan, append=True)
    delivered = {p: [] for p in peers}

    def drain():
        for p, ep in eps.items():
            while not ep.inbound.empty():
                env = ep.inbound.get_nowait()
                delivered[p].append((env.kind, env.sender, env.topic, env.data))

    sent = []
    for tick in range(12):
        if tick == 4:
            hub.set_partition("a", 1)
            hub.set_partition("b", 1)
        if tick == 7:
            hub.clear_partitions()
        if tick == 9:
            hub.unregister("d")
            eps["d"] = hub.register("d")
            hub.connect("a", "d")
        for _ in range(24):
            s, r = rng.choice(peers, 2, replace=False)
            env = mod.Envelope(kind=kinds[int(rng.integers(4))], sender=str(s), topic="t",
                               data=rng.integers(0, 256, int(rng.integers(1, 40)),
                                                 dtype=np.uint8).tobytes())
            sent.append(eps[str(s)].send(str(r), env))
        hub.advance_tick()
        drain()
    for _ in range(6):
        hub.advance_tick()
        drain()
    return {"sent": sent, "schedule": hub.schedule(), "digest": hub.schedule_digest(),
            "delivered": delivered, "counters": hub.fault_counters()}


@pytest.mark.parametrize("seed", [3, 11])
def test_hub_schedule_matches_jax(seed):
    """Both packages' hubs under the same seed, plans, partitions and
    traffic: the same schedules and digest, the same envelopes delivered to
    each peer in the same order, the same fault counters."""
    got, want = hub_run(transport, seed), hub_run(j_transport, seed)
    assert got == want
    counters = got["counters"]
    for key in ("dropped_partition", "duplicated", "reordered", "delayed"):
        assert counters.get(key), (key, counters)


# --------------------------------- the JAX package's test_hub_faults.py


def _drain(endpoint):
    out = []
    while not endpoint.inbound.empty():
        out.append(endpoint.inbound.get_nowait())
    return out


def _scripted_run(seed, n_messages=64, plan=None, ticks=8):
    """One deterministic traffic run: a->b gossip stream under ``plan``.
    Returns (delivered payloads in order, schedule dict, digest)."""
    hub = Hub(seed=seed)
    a = hub.register("a")
    b = hub.register("b")
    hub.connect("a", "b")
    hub.record_schedule()
    hub.set_link_plan(
        "a", "b",
        plan or LinkPlan(drop=0.25, delay=1, jitter=2, duplicate=0.15,
                         reorder=0.4))
    for i in range(n_messages):
        a.send("b", Envelope(kind="gossip", sender="a", topic="t",
                             data=bytes([i])))
    for _ in range(ticks):
        hub.advance_tick()
    payloads = [env.data for env in _drain(b)]
    return payloads, hub.schedule(), hub.schedule_digest()


class TestDeterminism:
    def test_same_seed_byte_identical_schedule(self):
        p1, s1, d1 = _scripted_run(seed=42)
        p2, s2, d2 = _scripted_run(seed=42)
        assert s1 == s2
        assert d1 == d2
        assert p1 == p2  # same drops, same delays, same drain order

    def test_different_seed_differs(self):
        _, _, d1 = _scripted_run(seed=1)
        _, _, d2 = _scripted_run(seed=2)
        assert d1 != d2

    def test_schedule_digest_is_link_sorted(self):
        """The digest must not depend on cross-link interleaving: two hubs
        receiving the same per-link streams in different global orders
        fingerprint identically."""
        plan = LinkPlan(drop=0.3, delay=1, jitter=1)
        digests = []
        for order in ((0, 1), (1, 0)):
            hub = Hub(seed=9)
            ep = {p: hub.register(p) for p in ("a", "b", "c")}
            hub.connect("a", "c")
            hub.connect("b", "c")
            hub.record_schedule()
            hub.set_link_plan("a", "c", plan)
            hub.set_link_plan("b", "c", plan)
            senders = ["a", "b"]
            for i in range(32):
                for k in order:
                    s = senders[k]
                    ep[s].send("c", Envelope(kind="gossip", sender=s,
                                             data=bytes([i])))
            digests.append(hub.schedule_digest())
        assert digests[0] == digests[1]


class TestComposition:
    def test_partition_drops_before_plan_dice(self):
        """A partitioned link drops outright and must NOT consume the
        plan's per-message decision stream — heal resumes the schedule
        exactly where it left off."""
        hub = Hub(seed=7)
        a = hub.register("a")
        b = hub.register("b")
        hub.connect("a", "b")
        hub.record_schedule()
        hub.set_link_plan("a", "b", LinkPlan(drop=0.5))
        for i in range(4):
            a.send("b", Envelope(kind="gossip", sender="a", data=bytes([i])))
        before = dict(hub.schedule())
        hub.set_partition("a", 1)
        for i in range(4, 8):
            a.send("b", Envelope(kind="gossip", sender="a", data=bytes([i])))
        assert hub.schedule() == before  # no decisions spent while severed
        assert hub.fault_counters().get("dropped_partition") == 4
        hub.clear_partitions()
        for i in range(8, 12):
            a.send("b", Envelope(kind="gossip", sender="a", data=bytes([i])))
        entries = hub.schedule()["a>b"]
        assert len(entries) == 8
        assert [e.split(":")[0] for e in entries] == [str(n) for n in range(8)]

    def test_delayed_envelope_respects_partition_at_drain(self):
        """An envelope sent pre-partition must not tunnel through one that
        forms before its due tick."""
        hub = Hub(seed=0)
        a = hub.register("a")
        b = hub.register("b")
        hub.connect("a", "b")
        hub.set_link_plan("a", "b", LinkPlan(delay=2))
        assert a.send("b", Envelope(kind="gossip", sender="a", data=b"x"))
        hub.set_partition("a", 1)
        hub.advance_tick()
        hub.advance_tick()
        assert _drain(b) == []
        assert hub.fault_counters().get("dropped_partition") == 1

    def test_duplicate_and_reorder(self):
        hub = Hub(seed=0)
        a = hub.register("a")
        b = hub.register("b")
        hub.connect("a", "b")
        hub.set_link_plan("a", "b", LinkPlan(delay=1, duplicate=1.0))
        a.send("b", Envelope(kind="gossip", sender="a", data=b"dup"))
        hub.advance_tick()
        assert [e.data for e in _drain(b)] == [b"dup", b"dup"]
        assert hub.fault_counters().get("duplicated") == 1
        # reorder: a later-sent always-reordered message jumps ahead of an
        # earlier normal one due at the same tick
        hub.set_link_plan("a", "b", LinkPlan(delay=1))
        a.send("b", Envelope(kind="gossip", sender="a", data=b"first"))
        hub.set_link_plan("a", "b", LinkPlan(delay=1, reorder=1.0))
        a.send("b", Envelope(kind="gossip", sender="a", data=b"second"))
        hub.advance_tick()
        assert [e.data for e in _drain(b)] == [b"second", b"first"]

    def test_kinds_filter_first_match_wins(self):
        """Stacked plans: gossip is dropped outright, RPC only delayed —
        the first plan whose kinds match decides."""
        hub = Hub(seed=0)
        a = hub.register("a")
        b = hub.register("b")
        hub.connect("a", "b")
        hub.set_link_plan("a", "b", LinkPlan(drop=1.0,
                                             kinds=frozenset({"gossip"})))
        hub.set_link_plan("a", "b",
                          LinkPlan(delay=1,
                                   kinds=frozenset({"rpc_request"})),
                          append=True)
        assert not a.send("b", Envelope(kind="gossip", sender="a", data=b"g"))
        assert a.send("b", Envelope(kind="rpc_request", sender="a", data=b"r"))
        assert _drain(b) == []  # rpc delayed, not dropped
        hub.advance_tick()
        assert [e.kind for e in _drain(b)] == ["rpc_request"]
        # unmatched kinds pass untouched
        assert a.send("b", Envelope(kind="rpc_response", sender="a", data=b"ok"))
        assert [e.kind for e in _drain(b)] == ["rpc_response"]

    def test_unregister_frees_peer_id_and_drops_delayed(self):
        hub = Hub(seed=0)
        a = hub.register("a")
        hub.register("b")
        hub.connect("a", "b")
        hub.set_link_plan("a", "b", LinkPlan(delay=1))
        a.send("b", Envelope(kind="gossip", sender="a", data=b"late"))
        hub.unregister("b")
        hub.advance_tick()
        assert hub.fault_counters().get("dropped_unlinked") == 1
        hub.register("b")  # a restarted node reuses its id


class TestNetDeliverPoint:
    def test_error_plan_drops(self):
        hub = Hub(seed=0)
        a = hub.register("a")
        b = hub.register("b")
        hub.connect("a", "b")
        fault_injection.install("net.deliver", "error", op="gossip")
        assert not a.send("b", Envelope(kind="gossip", sender="a", data=b"x"))
        # rpc kind unaffected by the op selector
        assert a.send("b", Envelope(kind="rpc_request", sender="a", data=b"y"))
        assert hub.fault_counters().get("dropped_fault") == 1
        assert [e.kind for e in _drain(b)] == ["rpc_request"]

    def test_corrupt_plan_flips_one_byte(self):
        hub = Hub(seed=0)
        a = hub.register("a")
        b = hub.register("b")
        hub.connect("a", "b")
        fault_injection.install("net.deliver", "corrupt")
        payload = bytes(range(32))
        assert a.send("b", Envelope(kind="gossip", sender="a", data=payload))
        (env,) = _drain(b)
        assert env.data != payload
        assert len(env.data) == len(payload)
        assert sum(x != y for x, y in zip(env.data, payload)) == 1


# ------------------------------ the JAX package's test_sync_hardening.py


@pytest.fixture()
def _fake():
    set_backend("fake")
    yield
    set_backend("host")


def _two_nodes(slots=16):
    ha = BeaconChainHarness(validator_count=16, fake_crypto=True,
                            genesis_time=GENESIS_TIME)
    hb = BeaconChainHarness(validator_count=16, fake_crypto=True,
                            genesis_time=GENESIS_TIME)
    ha.extend_chain(slots)
    for _ in range(slots):
        hb.advance_slot()
    hub = Hub()
    na = LocalNode(hub=hub, peer_id="a", harness=ha)
    nb = LocalNode(hub=hub, peer_id="b", harness=hb)
    # link WITHOUT the on_connect status dance: range sync must not race
    # the parent chase under test
    with hub._lock:
        hub._links.add(("a", "b"))
    return hub, ha, hb, na, nb


@pytest.mark.usefixtures("_fake")
def test_parent_chase_depth_cap_reports_metric():
    """A parent chain deeper than the cap aborts with a penalty and a
    ``sync_lookup_aborted_total{reason="depth_limit"}`` tick — it must not
    walk the whole chain."""
    hub, ha, hb, na, nb = _two_nodes(slots=12)
    try:
        before = metrics.SYNC_LOOKUP_ABORTED.get(reason="depth_limit")
        tip_root = ha.chain.head_root
        tip = ha.chain.get_block(tip_root)
        nb.sync.on_unknown_parent(tip, "a", depth_limit=3)
        assert metrics.SYNC_LOOKUP_ABORTED.get(reason="depth_limit") == before + 1
        assert not nb.chain.fork_choice.contains_block(tip_root)
        assert nb.service.peer_manager._peer("a").score < 0
        # with an adequate cap the same chase succeeds
        nb.sync.on_unknown_parent(tip, "a", depth_limit=32)
        assert nb.chain.fork_choice.contains_block(tip_root)
    finally:
        na.shutdown()
        nb.shutdown()


@pytest.mark.usefixtures("_fake")
def test_backfill_dead_peer_retries_against_fallback():
    """The preferred backfill peer is dead: the batch request fails fast,
    is retried once against the fallback, and history still completes
    (``backfill_batch_retries_total{outcome="recovered"}``)."""
    from lighthouse_tpu_torch.chain.beacon_chain import BeaconChain
    from lighthouse_tpu_torch.chain.slot_clock import ManualSlotClock

    ha = BeaconChainHarness(validator_count=16, fake_crypto=True,
                            genesis_time=GENESIS_TIME)
    ha.extend_chain(ha.spec.slots_per_epoch * 5)
    f_epoch, f_root = ha.chain.finalized_checkpoint()
    assert f_epoch >= 1
    anchor_block = ha.chain.get_block(f_root)
    anchor_state = ha.chain.get_state(f_root).copy()
    clock = ManualSlotClock(GENESIS_TIME, ha.spec.seconds_per_slot)
    clock.set_slot(ha.chain.current_slot())
    chain_b = BeaconChain(
        genesis_state=anchor_state, types=ha.types, spec=ha.spec,
        slot_clock=clock, anchor_block=anchor_block,
    )
    hub = Hub()
    na = LocalNode(hub=hub, peer_id="a", harness=ha)
    nb = LocalNode(hub=hub, peer_id="b", chain=chain_b)
    hub.register("dead")  # registered but never answers: timeouts, not NACKs
    try:
        hub.connect("a", "b")
        with hub._lock:  # silent link so the request rides the timeout path
            hub._links.add(("b", "dead"))
        retried = metrics.BACKFILL_BATCH_RETRIES.get(outcome="retried")
        recovered = metrics.BACKFILL_BATCH_RETRIES.get(outcome="recovered")
        backfill = BackfillSync(chain=chain_b, service=nb.service)
        filled = backfill.backfill_from(
            "dead", request_timeout=1.0, fallback_peers=["a"])
        assert backfill.complete, "fallback peer must complete backfill"
        assert filled == int(anchor_state.slot) - 1
        assert metrics.BACKFILL_BATCH_RETRIES.get(outcome="retried") > retried
        assert (metrics.BACKFILL_BATCH_RETRIES.get(outcome="recovered")
                > recovered)
    finally:
        na.shutdown()
        nb.shutdown()


@pytest.mark.usefixtures("_fake")
def test_backfill_no_fallback_keeps_old_behavior():
    """Without fallbacks a failing peer just ends the round (no retry
    counters, no exception)."""
    ha = BeaconChainHarness(validator_count=16, fake_crypto=True,
                            genesis_time=GENESIS_TIME)
    hub = Hub()
    nb = LocalNode(hub=hub, peer_id="b", harness=ha)
    hub.register("dead")
    try:
        with hub._lock:
            hub._links.add(("b", "dead"))
        exhausted = metrics.BACKFILL_BATCH_RETRIES.get(outcome="exhausted")
        backfill = BackfillSync(chain=ha.chain, service=nb.service)
        backfill.oldest_slot = 8  # pretend there is history to fill
        backfill.expected_parent = b"\x11" * 32
        assert backfill.backfill_from("dead", request_timeout=1.0) == 0
        assert (metrics.BACKFILL_BATCH_RETRIES.get(outcome="exhausted")
                == exhausted)
    finally:
        nb.shutdown()
