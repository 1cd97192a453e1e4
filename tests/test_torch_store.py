"""The port's store (``store/``, the native lockbox engine) vs the JAX
package's.

``lighthouse_tpu_torch.store`` copies the JAX package's ``store/`` and
``native/lockbox.cc`` (built by the port's g++ loader into
``lighthouse_tpu_torch/build/``).  Every comparison is exact:

- the same puts, deletes and a compaction leave a lockbox file
  byte-identical in both packages, before and after the compaction;
- a ``chain.db`` (and a freezer file) written by the JAX package's harness
  chain across finality opens in the port's ``HotColdDB``: every key of
  every column reads back with the same bytes, the blocks and hot states
  decode to the same SSZ, the split is the same, and the cold states (a
  restore point and a replayed slot) equal the JAX package's;
- the JAX package's ``test_store.py`` cases re-pointed at the port
  (lockbox persistence, crash recovery, compaction, hot/cold migration,
  reopen), on the port's CPU routes (host tree hashing, the numpy epoch
  backend).
"""

import os

import pytest

pytest.importorskip("jax")

from lighthouse_tpu.chain import BeaconChainHarness as JHarness  # noqa: E402
from lighthouse_tpu.store import HotColdDB as JHotColdDB  # noqa: E402
from lighthouse_tpu.store.lockbox_store import LockboxStore as JLockboxStore  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.store import DBColumn, HotColdDB  # noqa: E402
from lighthouse_tpu_torch.store.lockbox_store import LockboxStore  # noqa: E402
from lighthouse_tpu_torch.types.containers import build_types  # noqa: E402
from test_torch_chain import (  # noqa: E402,F401
    jax_backend,
    one_torch_thread,
    port_cpu,
    specs,
)

COLUMNS = sorted(v for k, v in vars(DBColumn).items() if not k.startswith("_"))


def lockbox_ops(store) -> None:
    """One sequence of puts (values across the 4 KiB read buffer),
    overwrites and deletes in three columns."""
    for i in range(40):
        store.put(b"blk", f"k{i:03d}".encode(), bytes([i]) * (i * 211))
    for i in range(0, 40, 3):
        store.put(b"blk", f"k{i:03d}".encode(), b"v2" * i)
    store.put(b"ste", b"big", b"\x5a" * 100_000)
    store.do_atomically([("put", b"bss", b"s1", b"one"), ("put", b"bss", b"s2", b"two"),
                         ("del", b"blk", b"k005", None)])
    for i in range(1, 40, 7):
        store.delete(b"blk", f"k{i:03d}".encode())
    store.flush()


def test_lockbox_file_byte_identical(tmp_path):
    """The same operations leave the same bytes on disk in both packages,
    before and after a compaction, and read back the same values."""
    paths = {}
    for name, cls in (("jax", JLockboxStore), ("port", LockboxStore)):
        path = str(tmp_path / f"{name}.db")
        store = cls(path)
        lockbox_ops(store)
        with open(path, "rb") as f:
            logged = f.read()
        store.compact()
        store.close()
        with open(path, "rb") as f:
            paths[name] = (logged, f.read())
    assert paths["port"][0] == paths["jax"][0]
    assert paths["port"][1] == paths["jax"][1]
    assert len(paths["port"][1]) < len(paths["port"][0])
    j, p = JLockboxStore(str(tmp_path / "jax.db")), LockboxStore(str(tmp_path / "port.db"))
    try:
        for column in (b"blk", b"ste", b"bss"):
            assert list(p.iter_column(column)) == list(j.iter_column(column))
    finally:
        j.close()
        p.close()


def test_jax_chain_db_reads_back_in_port(tmp_path):
    """A JAX-written hot and cold lockbox pair (a harness chain across
    finality) opens in the port's HotColdDB with the same bytes."""
    j_spec, p_spec = specs({})
    hot_p, cold_p = str(tmp_path / "chain.db"), str(tmp_path / "freezer.db")
    with jax_backend("fake"):
        hs = JHarness(validator_count=16, fake_crypto=True, spec=j_spec)
        jhot, jcold = JLockboxStore(hot_p), JLockboxStore(cold_p)
        hs.chain.store = jhot
        hs.chain.db = JHotColdDB(hot=jhot, cold=jcold, types=hs.types, spec=hs.spec)
        roots = hs.extend_chain(5 * 8)
        jdb = hs.chain.db
        split = jdb.get_split_slot()
        assert split >= 24
        expect = {c: list(jhot.iter_column(c)) + [(b"cold:" + k, v) for k, v in jcold.iter_column(c)]
                  for c in COLUMNS}
        j_cold = {slot: jdb.load_cold_state_by_slot(slot).as_ssz_bytes() for slot in (16, 19)}
        j_head = hs.chain.head_state.as_ssz_bytes()
        jhot.close()
        jcold.close()
    p_types = build_types(p_spec.preset)
    hot, cold = LockboxStore(hot_p), LockboxStore(cold_p)
    try:
        db = HotColdDB(hot=hot, cold=cold, types=p_types, spec=p_spec)
        got = {c: list(hot.iter_column(c)) + [(b"cold:" + k, v) for k, v in cold.iter_column(c)]
               for c in COLUMNS}
        assert got == expect
        assert db.get_split_slot() == split
        for root in roots:
            block = db.get_block(root)
            assert block.message.hash_tree_root() == root
            raw = hot.get(DBColumn.BEACON_BLOCK, root)
            assert raw.split(b"\x00", 1)[1] == block.as_ssz_bytes()
        for key, raw in hot.iter_column(DBColumn.BEACON_STATE):
            state = db.get_hot_state(key)
            assert raw.split(b"\x00", 1)[1] == state.as_ssz_bytes()
            assert state.hash_tree_root() == key
        head = db.get_block(roots[-1])
        assert db.get_hot_state(bytes(head.message.state_root)).as_ssz_bytes() == j_head
        for slot, ssz_bytes in j_cold.items():
            assert db.load_cold_state_by_slot(slot).as_ssz_bytes() == ssz_bytes
    finally:
        hot.close()
        cold.close()


# ------------------------------------- the JAX package's store tests, re-pointed


class TestLockbox:
    def test_roundtrip(self, tmp_path):
        db = LockboxStore(str(tmp_path / "db.log"))
        db.put(b"blk", b"key1", b"value1")
        db.put(b"blk", b"key2", b"v" * 100_000)  # > initial 4k read buffer
        assert db.get(b"blk", b"key1") == b"value1"
        assert db.get(b"blk", b"key2") == b"v" * 100_000
        assert db.get(b"ste", b"key1") is None  # column isolation
        db.delete(b"blk", b"key1")
        assert db.get(b"blk", b"key1") is None
        db.close()

    def test_persistence_across_reopen(self, tmp_path):
        path = str(tmp_path / "db.log")
        db = LockboxStore(path)
        for i in range(50):
            db.put(b"blk", f"k{i}".encode(), f"val{i}".encode() * 10)
        db.delete(b"blk", b"k7")
        db.close()
        db2 = LockboxStore(path)
        assert db2.get(b"blk", b"k3") == b"val3" * 10
        assert db2.get(b"blk", b"k7") is None
        db2.close()

    def test_torn_tail_recovered(self, tmp_path):
        path = str(tmp_path / "db.log")
        db = LockboxStore(path)
        db.put(b"blk", b"good", b"data")
        db.flush()
        db.close()
        with open(path, "ab") as f:  # simulate crash mid-append
            f.write(b"\x01\xff\xff")
        db2 = LockboxStore(path)
        assert db2.get(b"blk", b"good") == b"data"
        db2.put(b"blk", b"after", b"crash")
        db2.close()
        db3 = LockboxStore(path)
        assert db3.get(b"blk", b"after") == b"crash"
        db3.close()

    def test_iter_column_sorted(self, tmp_path):
        db = LockboxStore(str(tmp_path / "db.log"))
        for k in [b"c", b"a", b"b"]:
            db.put(b"blk", k, k.upper())
        db.put(b"ste", b"x", b"other-column")
        items = list(db.iter_column(b"blk"))
        assert items == [(b"a", b"A"), (b"b", b"B"), (b"c", b"C")]
        db.close()

    def test_compaction_preserves_data_and_shrinks(self, tmp_path):
        path = str(tmp_path / "db.log")
        db = LockboxStore(path)
        for i in range(100):
            db.put(b"blk", b"hot-key", f"version{i}".encode() * 50)
        db.put(b"blk", b"keep", b"kept")
        db.flush()
        before = os.path.getsize(path)
        db.compact()
        after = os.path.getsize(path)
        assert after < before / 10
        assert db.get(b"blk", b"hot-key") == b"version99" * 50
        assert db.get(b"blk", b"keep") == b"kept"
        db.close()
        db2 = LockboxStore(path)
        assert db2.get(b"blk", b"keep") == b"kept"
        db2.close()


class TestHotColdMigration:
    def test_chain_finalization_freezes_history(self):
        h = BeaconChainHarness(validator_count=16, fake_crypto=True)
        h.extend_chain(5 * 8)  # finalizes epoch 3 (slot 24)
        chain = h.chain
        assert h.finalized_epoch() >= 3
        db = chain.db
        split = db.get_split_slot()
        assert split >= 24
        # Frozen roots are queryable from the freezer
        for slot in range(1, split):
            assert db.cold_block_root_at_slot(slot) is not None
        # Restore point at slot 16 (2 epochs default spacing) exists
        state16 = db.load_cold_state_by_slot(16)
        assert state16 is not None and int(state16.slot) == 16
        # Replay reconstruction: a non-restore-point slot
        state19 = db.load_cold_state_by_slot(19)
        assert state19 is not None and int(state19.slot) == 19
        assert (
            state19.hash_tree_root()
            == db.cold_state_root_at_slot(19)
        )
        # Hot object cache pruned below the split (head-side retained)
        assert all(chain._blocks_slot(r) >= split or r == chain.fork_choice.finalized_checkpoint[1]
                   for r in chain._states)

    def test_blocks_survive_migration(self):
        h = BeaconChainHarness(validator_count=16, fake_crypto=True)
        roots = h.extend_chain(5 * 8)
        db = h.chain.db
        # All blocks (frozen or not) remain fetchable by root
        for root in roots:
            blk = db.get_block(root)
            assert blk is not None

    def test_hot_state_roundtrip(self):
        h = BeaconChainHarness(validator_count=16, fake_crypto=True)
        h.extend_chain(2)
        chain = h.chain
        state = chain.head_state
        loaded = chain.db.get_hot_state(state.hash_tree_root())
        assert loaded is not None
        assert loaded.hash_tree_root() == state.hash_tree_root()
        summary = chain.db.get_state_summary(state.hash_tree_root())
        assert summary.slot == int(state.slot)
        assert summary.latest_block_root == chain.head_root

    def test_chain_on_lockbox_store(self, tmp_path):
        """Full chain writing through the native engine."""
        store = LockboxStore(str(tmp_path / "chain.db"))
        h = BeaconChainHarness(validator_count=16, fake_crypto=True)
        h.chain.store = store
        h.chain.db = HotColdDB(hot=store, types=h.types, spec=h.spec)
        roots = h.extend_chain(8)
        assert h.chain.db.get_block(roots[-1]) is not None
        store.close()

    def test_skip_slots_migrate_correctly(self):
        """Skip slots must not corrupt frozen roots or lose restore points
        (regression: restore-point slots landing on skips made whole spans
        unloadable, and state roots for skips were the previous block's)."""
        h = BeaconChainHarness(validator_count=16, fake_crypto=True)
        # Block at every slot except 15,16,17 — slot 16 is a restore point.
        for _ in range(14):
            h.extend_chain(1)
        for _ in range(3):
            h.advance_slot()  # skip 15,16,17
        for _ in range(5 * 8 - 17):
            h.extend_chain(1)
        chain = h.chain
        assert h.finalized_epoch() >= 3
        db = chain.db
        split = db.get_split_slot()
        assert split > 17
        # Skip-slot state root equals the slot-advanced state's root.
        st16 = db.load_cold_state_by_slot(16)
        assert st16 is not None and int(st16.slot) == 16
        assert st16.hash_tree_root() == db.cold_state_root_at_slot(16)
        # Block root at the skip repeats the last block before it.
        assert db.cold_block_root_at_slot(16) == db.cold_block_root_at_slot(14)

    def test_frozen_history_survives_reopen(self, tmp_path):
        """Hot + cold both persistent: the full checkpoint/resume story."""
        hot_p, cold_p = str(tmp_path / "chain.db"), str(tmp_path / "freezer.db")
        hot, cold = LockboxStore(hot_p), LockboxStore(cold_p)
        h = BeaconChainHarness(validator_count=16, fake_crypto=True)
        h.chain.store = hot
        h.chain.db = HotColdDB(hot=hot, cold=cold, types=h.types, spec=h.spec)
        roots = h.extend_chain(5 * 8)
        split = h.chain.db.get_split_slot()
        assert split >= 24
        hot.close()
        cold.close()

        hot2, cold2 = LockboxStore(hot_p), LockboxStore(cold_p)
        db2 = HotColdDB(hot=hot2, cold=cold2, types=h.types, spec=h.spec)
        assert db2.get_split_slot() == split
        assert db2.get_block(roots[-1]) is not None
        assert db2.cold_block_root_at_slot(10) is not None
        state = db2.load_cold_state_by_slot(19)
        assert state is not None and int(state.slot) == 19
        hot2.close()
        cold2.close()
