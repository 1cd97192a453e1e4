"""The port's virtual clock (``virtual_clock.py``) and the settle and
peer-score paths that run on it.

``lighthouse_tpu_torch.virtual_clock`` copies the JAX package's module
(pure stdlib).  These are the JAX package's ``test_virtual_clock.py``
cases re-pointed at the port: tick and slot math, the production
``WallClock`` and legacy-callable shims, settle convergence on an injected
clock (the port's ``Simulator`` on its CPU routes: host tree hashing, the
numpy epoch backend, fake crypto), and peer-score decay as a function of
virtual time alone.
"""

import time

import pytest

pytest.importorskip("jax")

from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.virtual_clock import (  # noqa: E402
    TICK_S,
    VirtualClock,
    WallClock,
    _CallableShim,
    ensure_clock,
    telemetry_stamp,
)
from test_torch_chain import one_torch_thread, port_cpu  # noqa: E402,F401


class TestTickSlotMath:
    def test_now_is_ticks_times_tick_s(self):
        c = VirtualClock()
        assert c.now() == 0.0
        c.advance(250)
        assert c.ticks == 250
        assert c.now() == pytest.approx(250 * TICK_S)

    def test_slot_derives_from_ticks(self):
        # 1 s slots at the default 2 ms tick -> 500 ticks per slot
        c = VirtualClock(seconds_per_slot=1.0)
        assert c.ticks_per_slot == 500
        assert c.slot() == 0
        c.advance(499)
        assert c.slot() == 0
        c.advance(1)
        assert c.slot() == 1
        c.advance(500 * 7)
        assert c.slot() == 8

    def test_explicit_ticks_per_slot_wins(self):
        c = VirtualClock(ticks_per_slot=10)
        c.advance(25)
        assert c.slot() == 2

    def test_snap_to_next_slot_reanchors(self):
        c = VirtualClock(ticks_per_slot=100)
        c.advance(37)  # schedule-dependent mid-slot accrual
        assert c.snap_to_next_slot() == 100
        assert c.slot() == 1
        # from a boundary, snapping advances one FULL slot (the stepped
        # slot always costs at least one slot of virtual time)
        assert c.snap_to_next_slot() == 200

    def test_clock_cannot_go_backwards(self):
        c = VirtualClock()
        with pytest.raises(ValueError):
            c.advance(-1)

    def test_constructor_validation(self):
        with pytest.raises(ValueError):
            VirtualClock(tick_s=0)
        with pytest.raises(ValueError):
            VirtualClock(ticks_per_slot=0)

    def test_charge_rounds_up_to_a_tick(self):
        c = VirtualClock()
        c.charge(TICK_S / 10)  # sub-tick waits still cost one tick
        assert c.ticks == 1
        c.charge(0.05)
        assert c.ticks == 1 + 25
        c.charge(0.0)
        c.charge(-1.0)
        assert c.ticks == 26

    def test_virtual_sleep_is_cheap_in_real_time(self):
        """The fault-hang seam: burning minutes of virtual time costs one
        real yield — what makes hundreds-of-epochs soaks affordable."""
        c = VirtualClock()
        t0 = telemetry_stamp()
        c.sleep(120.0)
        real = telemetry_stamp() - t0
        assert c.now() == pytest.approx(120.0)
        assert real < 5.0  # one yield, not two virtual minutes

    def test_lull_advances_the_equivalent_ticks(self):
        c = VirtualClock()
        c.lull(0.004)
        assert c.ticks == 2


class TestClockCoercion:
    def test_none_is_wall_clock(self):
        assert isinstance(ensure_clock(None), WallClock)

    def test_clock_instances_pass_through(self):
        c = VirtualClock()
        assert ensure_clock(c) is c
        w = WallClock()
        assert ensure_clock(w) is w

    def test_legacy_callable_is_shimmed(self):
        t = [42.0]
        shim = ensure_clock(lambda: t[0])
        assert isinstance(shim, _CallableShim)
        assert shim.now() == 42.0
        t[0] = 43.5
        assert shim.now() == 43.5
        # virtual-only operations are no-ops on a shim
        shim.charge(10.0)
        shim.advance(1000)
        shim.snap_to_next_slot()
        assert shim.now() == 43.5

    def test_junk_is_rejected(self):
        with pytest.raises(TypeError):
            ensure_clock(7)

    def test_wall_clock_tracks_real_time(self):
        w = WallClock()
        a = w.now()
        time.sleep(0.01)
        assert w.now() > a
        # advance/charge/snap are no-ops: wall time advances itself
        before = w.ticks
        w.advance(10_000)
        w.charge(10_000.0)
        assert w.ticks - before < 10_000


class TestSettleOnInjectedClock:
    @pytest.fixture(autouse=True)
    def _fake(self):
        set_backend("fake")
        yield

    def test_settle_converges_and_charges_virtual_time(self):
        from lighthouse_tpu_torch.simulator import Simulator

        clock = VirtualClock()
        sim = Simulator(node_count=2, validator_count=8, clock=clock)
        try:
            before = clock.now()
            for _ in range(3):
                sim.run_slot()
            assert sim.settle(timeout=30.0)
            # the settle budget was spent in VIRTUAL seconds: the clock
            # moved, and bounded by the timeout plus the work performed
            assert clock.now() > before
            heads = {n.chain.head_root for n in sim.live_nodes}
            assert len(heads) == 1
        finally:
            sim.shutdown()

    def test_settle_timeout_is_virtual_not_wall(self):
        """A settle deadline on an idle-but-unconverged fleet expires in
        virtual time: the real time spent is a fraction of the virtual
        budget (the old wall-clock settle would have burned the full
        timeout in real seconds)."""
        from lighthouse_tpu_torch.simulator import Simulator

        clock = VirtualClock()
        sim = Simulator(node_count=2, validator_count=8, clock=clock)
        try:
            sim.run_slot(require_converged=False)
            t0 = telemetry_stamp()
            sim.settle(timeout=30.0)
            real = telemetry_stamp() - t0
            assert real < 30.0  # virtual budget, not a wall-clock burn
        finally:
            sim.shutdown()


class TestDecayDeterminismUnderJitter:
    def _run(self, jitter_s):
        """One peer-score episode driven entirely by a VirtualClock, with
        artificial scheduler jitter (real sleeps) injected between steps.
        Returns the decayed score trace."""
        from lighthouse_tpu_torch.network.peer_manager import PeerAction, PeerManager

        clock = VirtualClock()
        pm = PeerManager(clock=clock.now)
        pm.on_connect("peer-a")
        trace = []
        for i in range(6):
            pm.report("peer-a", PeerAction.LOW_TOLERANCE)
            if jitter_s:
                time.sleep(jitter_s)  # host load: invisible to the clock
            clock.advance(clock.ticks_per_slot)  # one virtual slot
            trace.append(round(pm.score("peer-a"), 6))
        return trace

    def test_decay_is_a_function_of_virtual_time_only(self):
        calm = self._run(jitter_s=0.0)
        jittered = self._run(jitter_s=0.02)
        assert calm == jittered
