"""The port's lock sanitizer (``locksmith.py``), case by case as the JAX
package's ``tests/test_locksmith.py``, plus two static checks.

- Off by default: the factories return the plain ``threading`` primitives,
  ``TimeoutLock``'s inner lock is plain, ``guard`` changes nothing.
- With ``LIGHTHOUSE_TPU_LOCK_SANITIZE=1``: the seeded two-thread order
  inversion and the seeded unguarded writes fail ``check()``; the proven
  order, a condition wait, an RLock re-entry and ``TimeoutLock``'s label
  routing stay green; the port's supervisor, both pipelines and a
  ``smoke_partition`` soak (``run_scenario(..., device="cpu")`` on the
  host routes) run with zero violations.
- Static: every ``lock_ownership`` entry names a file, class, lock and
  guarded attributes that exist in the port's source (parsed with
  ``ast``), and ``lock_graph.EDGES`` is
  ``lock_order_pass.acquisition_edges`` over the port's paths, where
  ``lock_order_pass.run`` finds no cycle.

The sanitizer is on only inside these tests (``monkeypatch.setenv``).
"""

import ast
import threading
from pathlib import Path

import pytest

from lighthouse_tpu_torch import lock_graph, lock_ownership, locksmith
from lighthouse_tpu_torch.lock_graph import EDGES
from lighthouse_tpu_torch.timeout_lock import TimeoutLock

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_sanitizer():
    locksmith.reset()
    yield
    locksmith.reset()


@pytest.fixture
def sanitize(monkeypatch):
    monkeypatch.setenv(locksmith.ENV_VAR, "1")


# --------------------------------------------------- zero overhead when off


class TestOffByDefault:
    def test_factories_return_plain_primitives(self, monkeypatch):
        monkeypatch.delenv(locksmith.ENV_VAR, raising=False)
        assert not locksmith.enabled()
        # the exact stdlib types — no wrapper, no indirection
        assert isinstance(locksmith.lock("X._lock"), type(threading.Lock()))
        assert isinstance(locksmith.rlock("X._rlock"), type(threading.RLock()))
        cond = locksmith.condition("X._cond")
        assert type(cond) is threading.Condition
        assert isinstance(cond._lock, type(threading.RLock()))

    def test_timeout_lock_inner_is_plain(self, monkeypatch):
        monkeypatch.delenv(locksmith.ENV_VAR, raising=False)
        tl = TimeoutLock("demo", label="Demo._lock")
        assert isinstance(tl._lock, type(threading.Lock()))

    def test_guard_is_a_no_op(self, monkeypatch):
        monkeypatch.delenv(locksmith.ENV_VAR, raising=False)

        class Box:
            pass

        b = Box()
        assert locksmith.guard(b, {"x": "_lock"}) is b
        assert type(b) is Box


# ------------------------------------------------- seeded failures (redden)


class TestSeededViolations:
    def test_two_thread_order_inversion_reddens(self, sanitize):
        """The static graph proves DeviceArbiter._lock -> ._stats; a second
        thread acquiring them inverted must fail the check."""
        assert ("DeviceArbiter._lock", "DeviceArbiter._stats") in EDGES
        a = locksmith.lock("DeviceArbiter._lock")
        s = locksmith.lock("DeviceArbiter._stats")

        def proven_order():
            with a:
                with s:
                    pass

        def inverted_order():
            with s:
                with a:
                    pass

        t1 = threading.Thread(target=proven_order, name="proven")
        t2 = threading.Thread(target=inverted_order, name="inverted")
        t1.start()
        t1.join()
        t2.start()
        t2.join()
        vs = locksmith.violations()
        assert len(vs) == 1 and "order-inversion" in vs[0]
        assert "inverted" in vs[0]  # names the offending thread
        with pytest.raises(locksmith.SanitizerViolation):
            locksmith.check()

    def test_seeded_unguarded_write_reddens(self, sanitize):
        class Demo:
            def __init__(self):
                self._lock = locksmith.lock("Demo._lock")
                self._state = 0  # __init__ writes are pre-guard: exempt

        d = Demo()
        locksmith.guard(d, {"_state": "_lock"})
        with d._lock:
            d._state = 1  # guarded: fine
        locksmith.check()
        d._state = 2  # unguarded: reddens
        with pytest.raises(locksmith.SanitizerViolation) as exc:
            locksmith.check()
        assert "unguarded-write" in str(exc.value)

    def test_unguarded_write_from_spawned_thread_reddens(self, sanitize):
        class Demo:
            def __init__(self):
                self._lock = locksmith.lock("Demo._lock")
                self._state = 0

        d = Demo()
        locksmith.guard(d, {"_state": "_lock"})
        t = threading.Thread(target=lambda: setattr(d, "_state", 3))
        t.start()
        t.join()
        with pytest.raises(locksmith.SanitizerViolation):
            locksmith.check()


# --------------------------------------------------------- sanctioned/clean


class TestCleanPatterns:
    def test_proven_order_and_sanctioned_pair_stay_green(self, sanitize):
        a = locksmith.lock("DeviceArbiter._lock")
        s = locksmith.lock("DeviceArbiter._stats")
        with a:
            with s:  # the statically proven direction
                pass
        locksmith.check()
        assert ("DeviceArbiter._lock", "DeviceArbiter._stats") in locksmith.observed_edges()

    def test_condition_wait_is_not_an_inversion(self, sanitize):
        cv = locksmith.condition("P._cond")
        other = locksmith.lock("Q._lock")
        done = []

        def waiter():
            with cv:
                while not done:
                    cv.wait(timeout=2.0)

        t = threading.Thread(target=waiter)
        t.start()
        with other:
            with cv:
                done.append(1)
                cv.notify_all()
        t.join(timeout=5.0)
        assert not t.is_alive()
        locksmith.check()

    def test_rlock_reentry_is_clean(self, sanitize):
        r = locksmith.rlock("R._rlock")
        with r:
            with r:
                pass
        locksmith.check()

    def test_timeout_lock_routes_label(self, sanitize):
        tl = TimeoutLock("demo", label="Demo._lock")
        assert isinstance(tl._lock, locksmith._SanitizedLock)
        other = locksmith.lock("Other._lock")
        with tl:
            with other:
                pass
        locksmith.check()
        assert ("Demo._lock", "Other._lock") in locksmith.observed_edges()


# --------------------------------------- green over the real subsystems


class TestRealSubsystemsGreen:
    """Fresh supervisor / pipeline / scenario objects of the port get
    instrumented locks (the variable is read at construction), their
    registered state gets write-guarded, and exercising them records zero
    violations."""

    def test_supervisor_breaker_green(self, sanitize):
        from lighthouse_tpu_torch import device_supervisor as ds

        cfg = ds.BreakerConfig(failure_threshold=2, open_cooldown_s=0.01, probe_successes=1)
        br = locksmith.guard(ds.CircuitBreaker("t", cfg))
        sup = locksmith.guard(ds.DeviceSupervisor(config=cfg))
        assert type(br).__name__ == "_GuardedCircuitBreaker"
        assert isinstance(br._lock._lock, locksmith._SanitizedLock)

        def hammer():
            for _ in range(5):
                br.record_failure("device_error")
                br.record_success()
                sup.breaker("opx").record_success()

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        locksmith.check()

    def test_device_pipeline_green(self, sanitize):
        from lighthouse_tpu_torch import device_pipeline
        from lighthouse_tpu_torch.crypto.bls.backends import set_backend

        class _StubSet:
            signing_keys = [1]

        set_backend("fake")
        try:
            p = locksmith.guard(device_pipeline.DevicePipeline(
                device="cpu", target_sets=2, linger_s=0.01,
                verify_flat_fn=lambda flat: True))
            assert type(p).__name__ == "_GuardedDevicePipeline"
            futs = [p.submit([_StubSet()]) for _ in range(4)]
            assert all(f.result(timeout=10.0) for f in futs)
            p.shutdown()
        finally:
            set_backend("host")
        locksmith.check()

    def test_job_pipeline_green(self, sanitize):
        from lighthouse_tpu_torch.device_pipeline import JobPipeline

        jp = locksmith.guard(JobPipeline("opy", device="cpu"))
        assert type(jp).__name__ == "_GuardedJobPipeline"
        futs = [jp.submit(lambda i=i: i * i) for i in range(8)]
        assert [f.result(timeout=10.0) for f in futs] == [i * i for i in range(8)]
        jp.shutdown()
        locksmith.check()

    def test_smoke_scenario_green(self, sanitize, tmp_path):
        from lighthouse_tpu_torch import blackbox, fault_injection
        from lighthouse_tpu_torch.consensus import per_epoch as pe
        from lighthouse_tpu_torch.crypto.bls.backends import set_backend
        from lighthouse_tpu_torch.ops import tree_hash as th
        from lighthouse_tpu_torch.scenarios import run_scenario, smoke_partition

        set_backend("fake")
        th.configure(enabled=False)
        pe.configure(backend="numpy")
        fault_injection.reset_for_tests()
        blackbox.reset_for_tests()
        blackbox.configure(directory=str(tmp_path / "postmortems"))
        made = []
        real_init = locksmith._SanitizedLock.__init__

        def counting_init(self, label):
            made.append(label)
            real_init(self, label)

        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(locksmith._SanitizedLock, "__init__", counting_init)
                artifact = run_scenario(smoke_partition(seed=0), out_dir=str(tmp_path),
                                        device="cpu")
        finally:
            fault_injection.reset_for_tests()
            blackbox.reset_for_tests()
            pe.reset_for_tests()
            th.reset_for_tests()
            set_backend("host")
        assert artifact["passed"]
        # the fleet's objects were built on sanitized locks
        assert {"Hub._lock", "BeaconProcessor._lock", "TelemetryScope._lock"} <= set(made)
        locksmith.check()


# ------------------------------------------------------------ static checks


def _class_attrs(cls_node: ast.ClassDef) -> set:
    """Every ``self.<attr>`` the class stores to, and its class-level names."""
    attrs = set()
    for n in ast.walk(cls_node):
        if (isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                and n.value.id == "self" and isinstance(n.ctx, ast.Store)):
            attrs.add(n.attr)
    for n in cls_node.body:
        targets = n.targets if isinstance(n, ast.Assign) else (
            [n.target] if isinstance(n, ast.AnnAssign) else [])
        attrs.update(t.id for t in targets if isinstance(t, ast.Name))
    return attrs


def _module_globals(tree: ast.Module) -> set:
    names = set()
    for n in tree.body:
        targets = n.targets if isinstance(n, ast.Assign) else (
            [n.target] if isinstance(n, ast.AnnAssign) else [])
        names.update(t.id for t in targets if isinstance(t, ast.Name))
    return names


def test_ownership_registry_names_the_ports_source():
    """Every entry names a port file, and in it a class, a lock attribute
    and guarded attributes (or a module lock and guarded globals) that
    exist: an entry naming an attribute the port lacks would make
    ``guard`` protect nothing.  Each registered lock is built by the
    sanitizer's factory (directly or through ``TimeoutLock``)."""
    registry = lock_ownership.LOCK_OWNERSHIP
    assert registry and all(path.startswith("lighthouse_tpu_torch/") for path in registry)
    checked = 0
    for path, entry in registry.items():
        source = (REPO / path).read_text()
        tree = ast.parse(source)
        classes = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)}
        for cls, locks in entry["classes"].items():
            assert cls in classes, f"{path}: no class {cls}"
            attrs = _class_attrs(classes[cls])
            for lock_attr, guarded in locks.items():
                assert lock_attr in attrs, f"{path}: {cls} has no {lock_attr}"
                label = f"{cls}.{lock_attr}"
                assert (f'"{label}"' in source), f"{path}: {label} not built by locksmith"
                missing = [a for a in guarded if a not in attrs]
                assert not missing, f"{path}: {cls} lacks {missing}"
                checked += 1 + len(guarded)
        names = _module_globals(tree)
        for lock_name, guarded in entry["module"].items():
            assert lock_name in names, f"{path}: no module lock {lock_name}"
            assert f'locksmith.lock("{Path(path).stem}.{lock_name}")' in source, lock_name
            missing = [g for g in guarded if g not in names]
            assert not missing, f"{path}: no module globals {missing}"
            checked += 1 + len(guarded)
    assert checked > 80
    # the registry is what guard() reads
    assert locksmith._ATTR_GUARDS["MeshState"]["_streams"] == "_lock"
    assert locksmith._ATTR_GUARDS["Controller"]["_walk_decision"] == "_lock"


def test_lock_graph_is_the_static_pass_over_the_port():
    """``EDGES`` is what the static pass computes over the port's paths
    (the JAX package's scan list under the port's package), and the pass
    finds no lock cycle there."""
    import sys

    sys.path.insert(0, str(REPO))
    from scripts.analysis import lock_order_pass

    assert lock_graph.SCAN_DIRS == tuple(
        d.replace("lighthouse_tpu/", "lighthouse_tpu_torch/", 1)
        for d in lock_order_pass.SCAN_DIRS)
    assert all((REPO / d).exists() for d in lock_graph.SCAN_DIRS)
    edges = lock_order_pass.acquisition_edges(str(REPO), lock_graph.SCAN_DIRS)
    assert tuple(edges) == EDGES
    cycles = [v for v in lock_order_pass.run(str(REPO), lock_graph.SCAN_DIRS)
              if "cycle" in v.code]
    assert cycles == []
    assert set(lock_ownership.SANCTIONED_ORDER_PAIRS) <= set(EDGES)
