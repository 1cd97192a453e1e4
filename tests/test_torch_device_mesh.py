"""The port's device mesh (``device_mesh.py``) vs the JAX package's.

- The JAX package's ``tests/test_device_mesh.py``, case by case: the same
  scripted sequences of ``configure``, ``note_failure``, ``force_trip`` and
  ``note_success`` run through the JAX ``device_mesh`` on the conftest's 8
  virtual CPU devices and through the port's over ``[cpu] * 8`` (the
  port's counterpart: a caller-given device list may name one device more
  than once).  ``summary()``, ``size()``, ``pad_rows``, ``scale_target``
  and ``shard_live_counts`` must be equal, the generation must move alike;
  the device naming differs (the port's ``device_names``; an error names a
  failing card as ``cuda:N`` or ``device N``, not ``TPU_N``).
- Sharded executions over ``[cpu] * 2`` and ``[cpu] * 3`` (the kernels'
  plain versions): a 3-set verify with one tampered set in each position
  (``fe`` the unsharded program's field element, the verdict the JAX host
  backend's), a valid batch through the supervised entry point, a 2-blob
  KZG batch, a ``sha256_pairs`` batch and a tree-hash root — each equal to
  the port's unsharded result and to the JAX package's verdict or bytes
  (its host backend and hashlib golden models: no JAX compile here).
- ``_dispatch_meshed``: a fault charged to a mesh member, then a second
  one that trips its breaker — the mesh re-shards and the batch retries.
- The epoch programs split over ``[cpu] * 2`` and ``[cpu] * 8`` (1,000
  validators padded to 1,024; 100 over 8, with shards made only of
  padding), both leak modes: the fused boundary and the staged deltas
  equal the unsharded port, the JAX package's unsharded programs (under
  ``jax.enable_x64``) and the numpy blocks; the combined-floor trap; a
  member fault in the middle of a boundary that re-shards; the flight
  records' ``mesh`` and ``shard_live``; ``shuffle_round``'s block form
  against the whole-list round.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu import device_mesh as jdm  # noqa: E402
from lighthouse_tpu import device_telemetry as jdt  # noqa: E402
from lighthouse_tpu.crypto.bls import api as japi  # noqa: E402
from lighthouse_tpu.crypto.bls.backends import host as jhost  # noqa: E402
from lighthouse_tpu.ops import tree_hash as jth  # noqa: E402
from lighthouse_tpu_torch import (  # noqa: E402
    device_mesh as pdm,
    device_supervisor,
    device_telemetry as pdt,
    fault_injection,
    metrics,
)
from lighthouse_tpu_torch.crypto.bls import api as papi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends.host import _rand_scalars  # noqa: E402
from lighthouse_tpu_torch.ops import (  # noqa: E402
    kzg_device,
    pairing,
    sha256_device,
    tower,
    tree_hash,
    verify,
)
from lighthouse_tpu_torch.ops import shuffle_device as psd  # noqa: E402
import test_torch_epoch as te  # noqa: E402
from test_torch_verify import Spec  # noqa: E402

CPU8 = ["cpu"] * 8
SEED = b"mesh"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean_mesh():
    jdm.reset_for_tests()
    pdm.reset_for_tests()
    yield
    jdm.reset_for_tests()
    pdm.reset_for_tests()
    fault_injection.clear()


def conf(pkg, spec=None):
    """``configure(spec)`` over each package's 8 devices."""
    if pkg is jdm:
        return jdm.configure(spec)
    return pdm.configure(spec, devices=CPU8)


def snap(pkg) -> dict:
    """``summary()`` without the topology generation (each process counts
    its own) and the port's device names."""
    out = dict(pkg.summary())
    out.pop("generation")
    names = out.pop("device_names", None)
    if names is not None:
        assert names == ["cpu"] * len(out["devices"])
    return out


def both(script):
    """Run ``script(pkg)`` on both packages; their results and summaries
    must be equal.  Returns the port's result."""
    jgen, pgen = jdm.generation(), pdm.generation()
    j_out = script(jdm)
    p_out = script(pdm)
    assert p_out == j_out
    assert snap(pdm) == snap(jdm)
    assert pdm.size() == jdm.size()
    assert pdm.generation() - pgen == jdm.generation() - jgen
    return p_out


# ------------------------------------------------------------- configure


def test_configure_disabled_by_default(monkeypatch):
    monkeypatch.delenv(pdm.MESH_ENV, raising=False)
    out = both(lambda pkg: (conf(pkg), pkg.enabled(), pkg.pad_rows(100)))
    assert out == (0, False, 100)


@pytest.mark.parametrize("spec", ["0", "off", ""])
def test_configure_explicit_off(spec):
    assert both(lambda pkg: (conf(pkg, spec), pkg.enabled())) == (0, False)


def test_configure_auto_takes_all_devices():
    both(lambda pkg: (conf(pkg, "auto"), pkg.enabled(), pkg.size()))
    snapshot = pdm.summary()
    assert snapshot["devices"] == list(range(8)) and snapshot["full_size"] == 8
    assert all(b["state"] == "closed" for b in snapshot["breakers"])


def test_configure_numeric_clamps_to_available():
    assert both(lambda pkg: (conf(pkg, "4"), conf(pkg, "64"))) == (4, 8)


def test_single_device_request_falls_back_transparently():
    assert both(lambda pkg: (conf(pkg, "1"), pkg.enabled())) == (0, False)


def test_env_spec_respected(monkeypatch):
    monkeypatch.setenv(pdm.MESH_ENV, "auto")
    assert both(lambda pkg: conf(pkg)) == 8


def test_default_devices_are_the_cards(monkeypatch):
    """Without a device list the mesh is every visible CUDA card: none
    here, so ``auto`` is the single-device branch production takes on a
    one-card machine."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pdm.configure("auto") == 0
    assert not pdm.enabled() and pdm.first_device() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pdm.configure("auto") == 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pdm.configure("auto") == 2
    assert pdm.summary()["device_names"] == ["cuda:0", "cuda:1"]


# ------------------------------------------------------------- pad_rows


def test_pad_rows_rounds_to_mesh_multiple():
    def script(pkg):
        conf(pkg, "8")
        out = [pkg.pad_rows(16), pkg.pad_rows(100), pkg.pad_rows(1)]
        pkg.force_trip(7)
        return out + [pkg.size(), pkg.pad_rows(128)]

    assert both(script) == [16, 104, 8, 7, 133]


# ---------------------------------------------------- per-device breakers


def test_force_trip_reshards_over_survivors():
    def script(pkg):
        conf(pkg, "auto")
        gen = pkg.generation()
        tripped = pkg.force_trip(3, reason="test")
        moved = pkg.generation() > gen
        again = pkg.force_trip(3)  # a dead member cannot trip twice
        return tripped, moved, again, pkg.summary()["reshards_total"]

    assert both(script) == (True, True, False, 1)
    assert 3 not in pdm.summary()["devices"]


def test_note_failure_threshold_then_trip(monkeypatch):
    monkeypatch.setenv(pdm.DEVICE_FAILURE_THRESHOLD_ENV, "2")

    def script(pkg):
        conf(pkg, "auto")
        # unattributable error: the deterministic suspect is the
        # highest-index survivor
        return [pkg.note_failure("device_error"), pkg.size(),
                pkg.note_failure("device_error")]

    assert both(script) == [False, 8, True]
    snapshot = pdm.summary()
    assert snapshot["size"] == 7 and 7 not in snapshot["devices"]
    assert snapshot["breakers"][7]["state"] == "open"


def test_note_success_keeps_thresholds_consecutive(monkeypatch):
    monkeypatch.setenv(pdm.DEVICE_FAILURE_THRESHOLD_ENV, "2")

    def script(pkg):
        conf(pkg, "auto")
        out = [pkg.note_failure("device_error")]
        pkg.note_success()
        out += [pkg.note_failure("device_error"), pkg.size()]
        pkg.force_trip(7)
        pkg.note_success()
        return out + [pkg.summary()["breakers"][7]["state"], pkg.size()]

    assert both(script) == [False, False, 8, "open", 7]


def test_grow_rows_pads_and_is_identity_at_size():
    arr = np.arange(12, dtype=np.int64).reshape(3, 4)
    assert pdm.grow_rows(arr, 3, 0) is arr
    grown, jgrown = pdm.grow_rows(arr, 5, 7), jdm.grow_rows(arr, 5, 7)
    assert grown.shape == (5, 4) and np.array_equal(grown, jgrown)
    assert np.array_equal(grown[:3], arr) and (grown[3:] == 7).all()


def test_note_failure_parses_device_from_error():
    conf(jdm, "auto")
    conf(pdm, "auto")
    jax_errors = ["transfer to TPU_3 failed: device or resource busy",
                  "device 5: halted", "device 42 exploded"]
    port_errors = ["transfer to cuda:3 failed: device or resource busy",
                   "device 5: halted", "device 42 exploded"]
    j = [jdm.STATE.suspect_device(RuntimeError(e)) for e in jax_errors]
    p = [pdm.STATE.suspect_device(RuntimeError(e)) for e in port_errors]
    assert p == j == [3, 5, 7]
    # a CPU mesh names members by mesh index; a card mesh by CUDA ordinal,
    # the highest-index member where several shards share the card
    assert pdm.STATE.suspect_device(RuntimeError("TPU_3 failed")) == 7
    pdm.configure("auto", devices=["cuda:0", "cuda:1", "cuda:1"])
    assert pdm.STATE.suspect_device(RuntimeError("CUDA error on device 0")) == 0
    assert pdm.STATE.suspect_device(RuntimeError("cuda:1 launch failed")) == 2
    assert pdm.STATE.suspect_device(RuntimeError("cuda:7 lost")) == 2
    assert pdm.STATE.suspect_device(None) == 2


def test_mesh_exhaustion_disables_mesh():
    def script(pkg):
        conf(pkg, "2")
        on = pkg.enabled()
        pkg.force_trip(1)
        return on, pkg.enabled(), pkg.pad_rows(100), pkg.size()

    assert both(script) == (True, False, 100, 1)
    assert pdm.first_device() is None


def test_reshard_invalidates_meshed_compile_mirror():
    def script(pkg):
        dt = jdt if pkg is jdm else pdt
        conf(pkg, "auto")
        dt.COMPILE_CACHE.clear()
        dt.note_dispatch("bls_verify", (16, 2), 1.0, mesh=8)
        dt.note_dispatch("bls_verify", (16, 2), 1.0)  # unsharded
        before = dt.COMPILE_CACHE.seen("bls_verify", (16, 2), mesh=8)
        pkg.force_trip(0)
        return (before, dt.COMPILE_CACHE.seen("bls_verify", (16, 2), mesh=8),
                dt.COMPILE_CACHE.seen("bls_verify", (16, 2)),
                [e["shape"] for e in dt.COMPILE_CACHE.inventory()])

    assert both(script) == (True, False, True, ["16x2"])


# --------------------------------------------------------- target scaling


def test_scale_target_shrinks_with_mesh():
    def script(pkg):
        out = [pkg.scale_target(4096)]
        conf(pkg, "auto")
        out.append(pkg.scale_target(4096))
        pkg.force_trip(7)
        out.append(pkg.scale_target(4096))
        pkg.force_trip(6)
        return out + [pkg.scale_target(4096)]

    assert both(script) == [4096, 4096, 4096 * 7 // 8, 4096 * 6 // 8]


def test_pipeline_snapshot_reports_effective_target():
    from lighthouse_tpu_torch.device_pipeline import DevicePipeline

    pdm.configure("auto", devices=CPU8)
    pipe = DevicePipeline("bls_verify", device="cpu", target_sets=64,
                          verify_flat_fn=lambda sets: True)
    try:
        assert pipe.snapshot()["effective_target_sets"] == 64
        pdm.force_trip(7)
        assert pipe.snapshot()["effective_target_sets"] == 56
    finally:
        pipe.shutdown(timeout=5.0)


# ------------------------------------------------------------ ShardedEntry


def test_sharded_entry_requires_registry_declaration():
    with pytest.raises(KeyError):
        pdm.ShardedEntry("lighthouse_tpu_torch/ops/nope.py:missing", lambda x: x)


def test_sharded_entry_rejects_undeclared_parameters():
    with pytest.raises(ValueError):
        pdm.ShardedEntry(sha256_device.ENTRY_KEY, lambda words, rogue: words)


def test_sharded_entry_placement_derives_from_registry():
    """The port's batched/replicated split of each entry's arguments is
    the JAX package's sharding specs: batched where jax shards ``dp``."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from lighthouse_tpu.ops import epoch_device as jed
    from lighthouse_tpu.ops import kzg_device as jkd
    from lighthouse_tpu.ops import verify as jverify
    from lighthouse_tpu_torch.ops import epoch_device as ped

    mesh = Mesh(np.array(jax.devices()), (jdm.AXIS,))
    cases = [
        (jdm.ShardedEntry(jverify.ENTRY_KEY, jverify._device_verify.__wrapped__),
         pdm.ShardedEntry(verify.ENTRY_KEY, verify._device_verify)),
        (jdm.ShardedEntry(jkd.ENTRY_KEY, jkd._device_kzg_batch.__wrapped__),
         pdm.ShardedEntry(kzg_device.ENTRY_KEY, kzg_device._device_kzg_batch)),
        (jdm.ShardedEntry(jed.ENTRY_KEY, jed._deltas_kernel.__wrapped__,
                          static_argnames=("in_leak",)),
         pdm.ShardedEntry("lighthouse_tpu_torch/ops/epoch_device.py:_deltas_kernel",
                          ped._deltas_kernel)),
    ]
    for jentry, pentry in cases:
        jax_batched = tuple(s.spec == P("dp") for s in jentry.in_shardings(mesh))
        assert pentry.arg_batched == jax_batched
        assert pentry.out_batched == jentry.out_batched
    assert cases[0][1].arg_batched == (True,) * 5
    assert cases[1][1].arg_batched == (True,) * 4 + (False,) * 3


def test_shard_live_counts_pack_padding_on_last_shards():
    def script(pkg):
        conf(pkg, "auto")
        if pkg is jdm:
            from lighthouse_tpu.ops import verify as jverify

            entry = jdm.ShardedEntry(jverify.ENTRY_KEY, jverify._device_verify.__wrapped__)
        else:
            entry = pdm.ShardedEntry(verify.ENTRY_KEY, verify._device_verify)
        out = [entry.shard_live_counts(100, 128)]
        pkg.force_trip(7)
        return out + [entry.shard_live_counts(12, 21)]

    assert both(script) == [[16, 16, 16, 16, 16, 16, 4, 0], [3, 3, 3, 3, 0, 0, 0]]


def test_place_splits_rows_and_copies_replicated():
    pdm.configure("auto", devices=["cpu"] * 3)
    entry = pdm.ShardedEntry(kzg_device.ENTRY_KEY, kzg_device._device_kzg_batch)
    rows = np.arange(6 * 25, dtype=np.int32).reshape(6, 25)
    bits = np.arange(6 * 256, dtype=np.int32).reshape(6, 256)
    rep = np.arange(256, dtype=np.int32)
    placed = entry.place((rows,) * 3, (rows,) * 3, bits, bits, rep, (rows[:2],) * 2,
                         (rows[:2],) * 2)
    assert len(placed) == 3
    for s, shard in enumerate(placed):
        assert np.array_equal(shard[0][1].numpy(), rows[2 * s: 2 * s + 2])
        assert np.array_equal(shard[2].numpy(), bits[2 * s: 2 * s + 2])
        assert np.array_equal(shard[4].numpy(), rep)
    with pytest.raises(ValueError):
        entry.place((rows[:5],) * 3, (rows[:5],) * 3, bits[:5], bits[:5], rep,
                    (rows[:2],) * 2, (rows[:2],) * 2)
    seen = []
    out = entry.run(lambda *a: (seen.append(pdm.current_shard()), a[2].sum())[1], placed)
    assert seen == [0, 1, 2] and pdm.current_shard() is None
    assert [int(x) for x in out] == [int(bits[2 * s: 2 * s + 2].sum()) for s in range(3)]


# ----------------------------------------------------- sharded executions


def _sets(api, tampered=None):
    """Three 2-key sets from fixed scalars; set ``tampered`` signed by
    other keys."""
    specs = [Spec(b"mesh set %d" % i, [11 * i + 3, 11 * i + 5]) for i in range(3)]
    if tampered is not None:
        specs[tampered] = Spec(specs[tampered].msg, specs[tampered].keys,
                               sig_keys=[97, 89])
    return [s.build(api) for s in specs]


def _fe_value(fe):
    return tower.fq12_from_limbs(fe)


@pytest.mark.parametrize("tampered", [0, 1, 2])
def test_sharded_verify_tampered_in_each_position(tampered):
    """A tampered set at each position, on 2 shards (rows [0, 1] and
    [2, 3]) and on 3 (one row each): ``fe`` the unsharded program's field
    element, so the verdict is the unsharded one and the JAX package's."""
    sets = _sets(papi, tampered)
    host = verify.build_batch(sets, _rand_scalars(3, SEED))
    fe, w_z = verify._device_verify(*verify.batch_from_numpy(host, "cpu"))
    want = _fe_value(fe)
    for shards, batch in ((2, host), (3, tuple(
            tuple(a[:3] for a in x) if isinstance(x, tuple) else x[:3] for x in host))):
        pdm.configure("auto", devices=["cpu"] * shards)
        placed, mesh, _, rows = verify.place_batch(batch, torch.device("cpu"))
        assert (mesh, rows) == (shards, 4 if shards == 2 else 3)
        fe_s, w_z_s = verify._run_placed(placed, mesh)
        assert _fe_value(fe_s) == want
        assert tower.fq2_from_limbs(w_z_s).is_zero() is tower.fq2_from_limbs(w_z).is_zero()
        assert pairing.fe_is_one(fe_s) is False
    assert jhost.verify_signature_sets(_sets(japi, tampered), seed=SEED) is False


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_verify_entry_point(shards):
    """A valid batch through the supervised entry point on the mesh: True,
    as the JAX host backend says, with its flight record's mesh fields."""
    pdm.configure("auto", devices=["cpu"] * shards)
    assert verify.verify_signature_sets_device(_sets(papi), seed=SEED, device="cpu") is True
    rec = pdt.FLIGHT_RECORDER.recent(1, op="bls_verify")[0]
    assert rec["shape"] == f"{pdm.pad_rows(4)}x2@dp{shards}"
    assert sum(rec["shard_live"]) == 3 and not rec["host_fallback"]
    if shards == 2:
        assert jhost.verify_signature_sets(_sets(japi), seed=SEED) is True


@pytest.fixture(scope="module")
def kzg_case():
    """A width-64 dev setup and two blobs with commitments and proofs from
    the JAX package's host model, and the port's ``Kzg`` on the CPU."""
    from lighthouse_tpu.crypto.kzg import Kzg as JKzg
    from lighthouse_tpu.crypto.kzg import TrustedSetup as JSetup
    from lighthouse_tpu_torch.crypto.kzg import Kzg, TrustedSetup
    from test_torch_kzg import TAU, WIDTH, make_blob

    jk = JKzg(JSetup.insecure_dev_setup(width=WIDTH, secret=TAU))
    blobs = [make_blob(70 + i) for i in range(2)]
    commitments = [jk.blob_to_kzg_commitment(b) for b in blobs]
    proofs = [jk.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, commitments)]
    pk = Kzg(TrustedSetup.insecure_dev_setup(width=WIDTH, secret=TAU), device="cpu")
    return jk, pk, blobs, commitments, proofs


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_kzg_batch(kzg_case, shards):
    """Two blobs through ``Kzg`` on the mesh: True, and False with the
    proofs swapped — the JAX host model's verdicts; the flight record is
    the sharded one."""
    jk, pk, blobs, commitments, proofs = kzg_case
    swapped = [proofs[1], proofs[0]]
    pdm.configure("auto", devices=["cpu"] * shards)
    assert pk.verify_blob_kzg_proof_batch(blobs, commitments, proofs) is True
    rec = pdt.FLIGHT_RECORDER.recent(1, op="kzg_batch")[0]
    assert rec["shape"] == f"{pdm.pad_rows(2)}@dp{shards}" and not rec["host_fallback"]
    assert pk.verify_blob_kzg_proof_batch(blobs, commitments, swapped) is False
    assert jk.verify_blob_kzg_proof_batch(blobs, commitments, proofs) is True
    assert jk.verify_blob_kzg_proof_batch(blobs, commitments, swapped) is False


def test_sharded_kzg_fe_is_the_unsharded_element():
    """The combine's ``fe`` is the unsharded program's field element on
    points that do not verify (so the element is not just 1)."""
    from lighthouse_tpu_torch.crypto.bls import curve
    from lighthouse_tpu_torch.crypto.bls.params import R

    c_pts = [curve.mul(curve.G1, i + 2) for i in range(3)]
    p_pts = [curve.mul(curve.G1, 3 * i + 1) for i in range(3)]
    args = (c_pts, p_pts, [pow(7, i, R) for i in range(3)], [11 + i for i in range(3)],
            [5 + 2 * i for i in range(3)], curve.mul(curve.G2, 1234567))
    host = kzg_device._build_kzg_batch(*args, 4)
    want = _fe_value(kzg_device._device_kzg_batch(*kzg_device.batch_from_numpy(host, "cpu")))
    assert not want.is_one()
    pdm.configure("auto", devices=["cpu"] * 2)
    assert _fe_value(kzg_device._run_sharded(host)) == want


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_sha256_pairs_bytes(shards):
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 300 * 64, dtype=np.uint8).tobytes()
    want = sha256_device.hash_pairs_device(data, device="cpu")
    pdm.configure("auto", devices=["cpu"] * shards)
    assert sha256_device.hash_pairs_device(data, device="cpu") == want
    assert want == jth.golden_hash_pairs(data)
    rec = pdt.FLIGHT_RECORDER.recent(1, op="sha256_pairs")[0]
    assert rec["shape"] == f"{pdm.pad_rows(1024)}@dp{shards}"
    assert sum(rec["shard_live"]) == 300


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_tree_hash_root(shards):
    """A 4,096-validator balance list's root through the subtree kernel's
    plain version on the mesh: byte for byte the unsharded root and the
    JAX package's hashlib golden root."""
    balances = np.random.default_rng(11).integers(
        16 * 10**9, 33 * 10**9, 4096, dtype=np.uint64)
    leaves = np.frombuffer(balances.astype("<u8").tobytes(), dtype=np.uint8).reshape(-1, 32)
    limit = (1 << 40) // 4
    tree_hash.configure(enabled=True, device="cpu")
    try:
        want = tree_hash.DeviceLeafTree(limit).update(leaves)
        pdm.configure("auto", devices=["cpu"] * shards)
        got = tree_hash.DeviceLeafTree(limit).update(leaves)
    finally:
        tree_hash.reset_for_tests()
    assert got == want == jth.golden_root(leaves, limit)
    rec = pdt.FLIGHT_RECORDER.recent(1, op="tree_hash")[0]
    assert rec["shape"].endswith(f"@dp{shards}")


def test_dispatch_meshed_reshards_and_retries(monkeypatch):
    """Two shards, member threshold 2: a first dispatch fault is charged
    to shard 1 (the deterministic suspect) and goes on into the split
    retry; a second one trips shard 1's breaker, the mesh re-shards to one
    member (off) and the batch retries single-device — right bytes both
    times, no host fallback, one reshard."""
    monkeypatch.delenv(pdm.DEVICE_FAILURE_THRESHOLD_ENV, raising=False)
    data = np.random.default_rng(3).integers(0, 256, 600 * 64, dtype=np.uint8).tobytes()
    want = jth.golden_hash_pairs(data)
    pdm.configure("auto", devices=["cpu"] * 2)
    reshards = sum(metrics.DEVICE_MESH_RESHARDS.snapshot().values())
    fallbacks = metrics.DEVICE_HOST_FALLBACK.snapshot()
    fault_injection.install("device.dispatch", "error", op="sha256_pairs", first_n=1)
    assert sha256_device.hash_pairs_device(data, device="cpu") == want
    snapshot = pdm.summary()
    assert snapshot["size"] == 2 and snapshot["breakers"][1]["failures"] == 1
    rec = pdt.FLIGHT_RECORDER.recent(1, op="sha256_pairs")[0]
    assert rec["shape"] == "1024@dp2" and not rec["host_fallback"]
    fault_injection.install("device.dispatch", "error", op="sha256_pairs", first_n=1)
    assert sha256_device.hash_pairs_device(data, device="cpu") == want
    snapshot = pdm.summary()
    assert (snapshot["size"], snapshot["enabled"], snapshot["reshards_total"]) == (1, False, 1)
    assert snapshot["breakers"][1]["state"] == "open"
    assert sum(metrics.DEVICE_MESH_RESHARDS.snapshot().values()) == reshards + 1
    assert metrics.DEVICE_HOST_FALLBACK.snapshot() == fallbacks
    rec = pdt.FLIGHT_RECORDER.recent(1, op="sha256_pairs")[0]
    assert rec["shape"] == "1024" and "mesh" not in rec
    assert device_supervisor.breaker_state("sha256_pairs") == "closed"


def test_device_summary_carries_mesh_and_autotune_sections():
    pdm.configure("auto", devices=["cpu"] * 2)
    summary = pdt.summary()
    assert summary["mesh"]["size"] == 2 and summary["mesh"]["device_names"] == ["cpu", "cpu"]
    assert set(summary["autotune"]) == {"mode", "overlay"}
    assert set(summary) == set(jdt.summary())


def test_epoch_ops_run_on_the_mesh_first_device():
    """Mesh on, the standalone shuffle and proposer programs still run
    whole on the mesh's first device (``op_device``), while the deltas and
    the fused boundary split over the members: their flight records carry
    the mesh size and each shard's live rows."""
    from lighthouse_tpu_torch.ops import epoch_device

    assert epoch_device.op_device("cpu") == torch.device("cpu")
    pdm.configure("auto", devices=["cpu", "cpu"])
    assert epoch_device.op_device("cpu") == pdm.first_device() == torch.device("cpu")
    assert epoch_device.mesh_rows(1024) == (2, 1024)
    plan = te.synth_plan(100)
    psd.epoch_boundary_device(plan, in_leak=False, device="cpu")
    epoch_device.epoch_deltas_device(te.arrays_of(plan), plan.prev_part, plan.inactivity,
                                     device="cpu", **te.deltas_kwargs(plan, False))
    psd.shuffle_device(np.arange(100), te.SEED, te.ROUNDS, device="cpu")
    for op in ("epoch_boundary", "epoch_deltas"):
        rec = pdt.FLIGHT_RECORDER.recent(1, op=op)[0]
        assert (rec["shape"], rec["mesh"], rec["shard_live"]) == ("256@dp2", 2, [100, 0])
    assert "mesh" not in pdt.FLIGHT_RECORDER.recent(1, op="shuffle")[0]


# ------------------------------------------------ the epoch programs split


#: (validators, mesh members): 1,000 padded to 1,024 over 2; 100 over 8,
#: which leaves shards made only of padding.
EPOCH_SPLITS = [(1000, 2), (100, 8)]
EPOCH_LEAK = pytest.mark.parametrize("leak", [False, True], ids=["no_leak", "leak"])


def _jax_boundary(plan, leak):
    """The JAX package's unsharded ``_boundary_kernel`` on the port's
    inputs for ``plan`` (under ``jax.enable_x64``), sliced as the entry
    point slices."""
    import jax
    import jax.numpy as jnp

    from lighthouse_tpu.ops import shuffle_device as jsd

    args, _ = psd.boundary_inputs(plan, torch.device("cpu"))
    with jax.enable_x64(True):
        out = jax.device_get(jsd._boundary_kernel(
            *(te.to_jax(a) for a in args[:16]), *(jnp.int64(v) for v in args[16:32]),
            jnp.int32(args[32]), in_leak=leak))
    out = [np.asarray(t) for t in out]
    return [t[:plan.n] for t in out[:6]] + [out[6][:plan.m], out[7], out[8]]


def _jax_deltas(plan, leak):
    import jax
    import jax.numpy as jnp

    from lighthouse_tpu.ops import epoch_device as jed
    from lighthouse_tpu_torch.ops import epoch_device as ped

    nb = ped._bucket(plan.n)
    batched = [ped.grow_rows(np.asarray(a), nb, f) for a, f in zip(
        (plan.effective_balance, plan.activation_epoch, plan.exit_epoch,
         plan.withdrawable_epoch, plan.slashed, plan.prev_part, plan.inactivity),
        ped._PAD_FILLS)]
    scalars = (plan.previous_epoch, plan.base_reward_per_increment, plan.total_active_balance,
               plan.increment, plan.inactivity_score_bias,
               plan.inactivity_score_recovery_rate, plan.quotient)
    with jax.enable_x64(True):
        out = jax.device_get(jed._deltas_kernel(
            *(jnp.asarray(a) for a in batched), *(jnp.int64(v) for v in scalars),
            in_leak=leak))
    return [np.asarray(t)[:plan.n] for t in out]


def _same(outs, *others):
    for i, o in enumerate(outs):
        for other in others:
            assert np.array_equal(o, np.asarray(other[i]).astype(o.dtype)), i


@EPOCH_LEAK
@pytest.mark.parametrize("n,shards", EPOCH_SPLITS)
def test_sharded_epoch_boundary_bit_identical(n, shards, leak):
    """The fused boundary over the mesh: every output (inactivity, balance
    delta, effective balance, the three masks, shuffling, proposers,
    found) equals the unsharded port, the JAX package's unsharded program
    and the numpy composite; the flight record carries the mesh and the
    per-shard live rows, and every shard ran each shuffle round."""
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.ops import cuda_epoch

    plan = te.synth_plan(n)
    unsharded = psd.epoch_boundary_device(plan, in_leak=leak, device="cpu")
    pdm.configure("auto", devices=["cpu"] * shards)
    calls = []
    real = cuda_epoch.shuffle_rounds

    def counted(*a, **kw):
        calls.append(pdm.current_shard())
        return real(*a, **kw)

    cuda_epoch.shuffle_rounds = counted
    try:
        sharded = psd.epoch_boundary_device(plan, in_leak=leak, device="cpu")
    finally:
        cuda_epoch.shuffle_rounds = real
    assert sharded[8].any()  # proposers found on the device path
    _same(sharded, unsharded, _jax_boundary(plan, leak),
          pe._epoch_boundary_numpy(plan, in_leak=leak))
    rec = pdt.FLIGHT_RECORDER.recent(
        1, op="epoch_boundary_leak" if leak else "epoch_boundary")[0]
    nb = psd._bucket(n)
    assert (rec["shape"], rec["mesh"]) == (f"{nb}@dp{shards}", shards)
    assert rec["shard_live"] == [max(0, min(nb // shards, n - s * nb // shards))
                                 for s in range(shards)]
    assert sum(rec["shard_live"]) == n
    assert calls == list(range(shards)) * te.ROUNDS


def test_sharded_shuffle_exchange_counts_its_bytes():
    """The split shuffle counts its exchange where it happens: members on
    the first member's own device get the list itself (no bytes copied),
    and each round gathers the whole padded list once."""
    plan = te.synth_plan(1000)
    pdm.configure("auto", devices=["cpu", "cpu"])
    psd.reset_exchange_bytes()
    psd.epoch_boundary_device(plan, in_leak=False, device="cpu")
    nb = psd._bucket(1000)
    assert psd.EXCHANGE_BYTES == {"copied": 0, "gathered": te.ROUNDS * nb * 4}


@EPOCH_LEAK
@pytest.mark.parametrize("n,shards", EPOCH_SPLITS)
def test_sharded_epoch_deltas_bit_identical(n, shards, leak):
    """The staged deltas over the mesh equal the unsharded port, the JAX
    package's unsharded program and the numpy per-epoch block."""
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.ops import epoch_device as ped

    plan = te.synth_plan(n)
    kwargs = te.deltas_kwargs(plan, leak)

    def run():
        return ped.epoch_deltas_device(te.arrays_of(plan), plan.prev_part, plan.inactivity,
                                       device="cpu", **kwargs)

    unsharded = run()
    pdm.configure("auto", devices=["cpu"] * shards)
    sharded = run()
    _same(sharded, unsharded, _jax_deltas(plan, leak),
          pe._epoch_deltas_numpy(te.arrays_of(plan), plan.prev_part, plan.inactivity,
                                 **kwargs))
    rec = pdt.FLIGHT_RECORDER.recent(1, op="epoch_deltas_leak" if leak else "epoch_deltas")[0]
    assert rec["mesh"] == shards and sum(rec["shard_live"]) == n


def test_sharded_deltas_floor_the_combined_sum():
    """Effective balances off the increment grid, so that the per-shard
    participating sums' floors add up to less than the combined sum's
    floor: the split floors the combined raw sum, as the unsharded
    program and the numpy block do."""
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.ops import epoch_device as ped

    plan = te.synth_plan(1000)
    plan.effective_balance = plan.effective_balance + te.GWEI * 3 // 4
    kwargs = te.deltas_kwargs(plan, False)
    arrays = te.arrays_of(plan)
    unsharded = ped.epoch_deltas_device(arrays, plan.prev_part, plan.inactivity, device="cpu",
                                        **kwargs)
    blocks = [[torch.from_numpy(np.asarray(a)[s * 512:(s + 1) * 512]) for a in (
        plan.effective_balance, plan.activation_epoch, plan.exit_epoch, plan.slashed,
        plan.prev_part)] for s in range(2)]
    sums = [ped._participating_sums(*b, plan.previous_epoch) for b in blocks]
    floors = sum(torch.div(x, te.GWEI, rounding_mode="floor") for x in sums)
    whole = torch.div(sums[0] + sums[1], te.GWEI, rounding_mode="floor")
    assert (floors != whole).all()  # the input separates the two
    pdm.configure("auto", devices=["cpu"] * 2)
    sharded = ped.epoch_deltas_device(arrays, plan.prev_part, plan.inactivity, device="cpu",
                                      **kwargs)
    _same(sharded, unsharded, pe._epoch_deltas_numpy(arrays, plan.prev_part, plan.inactivity,
                                                     **kwargs))
    pboundary = psd.epoch_boundary_device(plan, in_leak=False, device="cpu")
    _same(pboundary, pe._epoch_boundary_numpy(plan, in_leak=False))


def test_sharded_boundary_member_fault_reshards(monkeypatch):
    """A member fails in the middle of a boundary (shard 1 in the shuffle's
    fourth round, the error naming its device): the supervisor charges it,
    its breaker trips (threshold 1), the mesh re-shards over the seven
    survivors (1,024 rows padded to 1,029) and the boundary retries there:
    the same answer, one reshard, no host fallback."""
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.ops import tree_hash as th

    monkeypatch.setenv(pdm.DEVICE_FAILURE_THRESHOLD_ENV, "1")
    plan = te.synth_plan(1000)
    want = psd.epoch_boundary_device(plan, in_leak=False, device="cpu")
    pdm.configure("auto", devices=CPU8)
    reshards = sum(metrics.DEVICE_MESH_RESHARDS.snapshot().values())
    fallbacks = metrics.DEVICE_HOST_FALLBACK.snapshot()
    real = psd._shuffle_block_shard
    seen = []

    def failing(values, *a):
        seen.append(pdm.current_shard())
        if pdm.size() == 8 and len(seen) == 3 * 8 + 2:
            raise RuntimeError("device 1: lost in the middle of a round")
        return real(values, *a)

    monkeypatch.setattr(psd, "_shuffle_block_shard", failing)
    th.configure(enabled=False)
    pe.configure(backend="device", fused_boundary=True, device="cpu")
    try:
        got = pe._run_boundary(plan, in_leak=False)
    finally:
        pe.reset_for_tests()
        th.reset_for_tests()
        device_supervisor.reset_for_tests()
    _same(got, want)
    assert seen[3 * 8 + 1] == 1 and pdm.size() == 7
    assert pdm.summary()["breakers"][1]["state"] == "open"
    assert sum(metrics.DEVICE_MESH_RESHARDS.snapshot().values()) == reshards + 1
    assert metrics.DEVICE_HOST_FALLBACK.snapshot() == fallbacks
    rec = pdt.FLIGHT_RECORDER.recent(1, op="epoch_boundary")[0]
    assert rec["shape"] == "1029@dp7" and sum(rec["shard_live"]) == 1000
    assert not rec["host_fallback"]


def test_sharded_boundary_entry_matches_the_jax_specs():
    """The boundary's placement (batched vs replicated, which outputs keep
    the batch axis) is the JAX package's sharding spec."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from lighthouse_tpu.ops import shuffle_device as jsd

    mesh = Mesh(np.array(jax.devices()), (jdm.AXIS,))
    jentry = jdm.ShardedEntry(jsd.ENTRY_KEY, jsd._boundary_kernel.__wrapped__,
                              static_argnames=("in_leak",))
    pentry = psd._sharded_entry()
    assert pentry.arg_batched == tuple(s.spec == P("dp") for s in jentry.in_shardings(mesh))
    assert pentry.out_batched == jentry.out_batched
    assert psd._BoundaryArgs._fields[-1] == "m_live" and len(psd._BoundaryArgs._fields) == 33


def test_place_passes_replicated_numbers_by_value():
    pdm.configure("auto", devices=["cpu"] * 2)
    placed = psd._sharded_entry().place(*psd.boundary_arrays(te.synth_plan(100), 256))
    for shard in placed:
        assert all(type(v) is int for v in shard[16:])
        assert all(isinstance(t, torch.Tensor) for t in shard[:16])
    assert psd._sharded_entry().blocks(256) == [(0, 128), (128, 128)]


@pytest.mark.parametrize("offset,count", [(0, 256), (0, 100), (60, 100), (97, 5), (100, 156),
                                          (200, 56), (255, 1), (3, 0)])
def test_shuffle_round_block_is_a_slice_of_the_whole_round(offset, count):
    """The offset form of one swap-or-not round (a shard's block, read from
    the whole list) equals the block of the whole-list round, for blocks
    before ``n_live`` (97), straddling it and made only of padding; a
    narrower block takes one round."""
    from lighthouse_tpu_torch.ops import cuda_epoch

    n, nb = 97, 256
    values = torch.from_numpy(np.random.default_rng(5).permutation(nb).astype(np.int32))
    pivots, digests = (torch.from_numpy(t) for t in psd.shuffle_tables(te.SEED, 4, n, nb))
    for r in range(4):
        one = (pivots[r:r + 1], digests[r:r + 1])
        whole = cuda_epoch.shuffle_rounds_plain(values, *one, n)
        block = cuda_epoch.shuffle_rounds_plain(values, *one, n, offset, count)
        assert torch.equal(block, whole[offset:offset + count])
        assert torch.equal(cuda_epoch.shuffle_rounds(values, *one, n, offset, count), block)
        if offset >= n:
            assert torch.equal(block, values[offset:offset + count])
    if count != nb:
        with pytest.raises(ValueError):
            cuda_epoch.shuffle_rounds(values, pivots, digests, n, offset, count)
