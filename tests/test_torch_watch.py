"""The port's ``watch/`` (the off-node analytics service) vs the JAX
package's.

- The JAX package's ``test_watch.py`` re-pointed at the port: the updater
  ingests a harness chain served by the port's Beacon API, the analytics
  server answers its routes;
- parity: the JAX package's ``WatchUpdater`` (its own client and
  ``WatchDB``) and the port's poll the same served chain over the same
  rounds; every row of every table is equal.

Chains run on the port's CPU routes (host tree hashing, the numpy epoch
backend) with fake crypto.
"""

import json
import urllib.request

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu.http_api import BeaconNodeHttpClient as JClient  # noqa: E402
from lighthouse_tpu.watch import WatchDB as JWatchDB  # noqa: E402
from lighthouse_tpu.watch import WatchUpdater as JWatchUpdater  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.http_api import BeaconNodeHttpClient, HttpApiServer  # noqa: E402
from lighthouse_tpu_torch.watch import WatchDB, WatchServer, WatchUpdater  # noqa: E402
from test_torch_chain import port_cpu  # noqa: E402,F401

TABLES = ("blocks", "skipped_slots", "attestation_performance", "block_packing",
          "block_rewards", "blockprint")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def rig():
    set_backend("fake")
    harness = BeaconChainHarness(validator_count=16, fake_crypto=True)
    server = HttpApiServer(harness.chain).start()
    db = WatchDB()
    updater = WatchUpdater(
        client=BeaconNodeHttpClient(server.url), db=db, spec=harness.spec
    )
    yield harness, server, db, updater
    server.stop()
    db.close()


def test_updater_ingests_chain(rig):
    harness, server, db, updater = rig
    spe = harness.spec.slots_per_epoch
    harness.extend_chain(spe * 3)
    n = updater.update()
    assert n == spe * 3
    assert db.highest_slot() == spe * 3
    row = db.block_at(1)
    assert row is not None and row["attestation_count"] >= 0
    assert row["sync_participation"] == 1.0  # harness blocks carry full sync
    # incremental: a second round ingests only the delta
    harness.extend_chain(2)
    assert updater.update() == 2

    # completed-epoch attestation performance landed
    rate = db.participation_rate(spe * 3 // spe - 2)
    assert rate is not None
    assert rate["target_rate"] > 0.9


def test_skipped_slots_recorded(rig):
    harness, server, db, updater = rig
    harness.extend_chain(2)
    harness.advance_slot()  # an empty slot
    harness.extend_chain(1)
    updater.update()
    assert db.block_at(3) is None
    assert db.block_at(4) is not None
    assert db.highest_slot() == 4


def test_watch_http_routes(rig):
    harness, server, db, updater = rig
    spe = harness.spec.slots_per_epoch
    harness.extend_chain(spe * 3)
    updater.update()
    ws = WatchServer(db).start()
    try:
        def get(path):
            with urllib.request.urlopen(ws.url + path, timeout=5) as r:
                return json.loads(r.read())

        blk = get("/v1/slots/1")["data"]
        assert blk["slot"] == 1
        proposer_slots = get(f"/v1/proposers/{blk['proposer']}")["data"]
        assert 1 in proposer_slots
        part = get(f"/v1/participation/{spe * 3 // spe - 2}")["data"]
        assert part["validators"] == 16
        sub = get(f"/v1/suboptimal_attestations/{spe * 3 // spe - 2}")["data"]
        assert isinstance(sub, list)  # full participation -> usually empty

        # analytics depth: packing, rewards, blockprint (reference
        # watch/src/{block_packing,block_rewards,blockprint})
        pack = get("/v1/packing/2")["data"]
        assert pack["slot"] == 2 and 0.0 <= pack["efficiency"] <= 1.0
        rew = get("/v1/rewards/2")["data"]
        assert rew["total"] >= rew["sync_committee_reward"] >= 0
        bp = get("/v1/blockprint/2")["data"]
        assert "best_guess" in bp
        summary = get("/v1/blockprint/summary")["data"]
        assert sum(summary.values()) >= spe * 3 - 1
    finally:
        ws.stop()


def rows(db) -> dict:
    with db._lock:
        return {t: db._conn.execute(f"SELECT * FROM {t} ORDER BY 1, 2").fetchall()
                if t == "attestation_performance" else
                db._conn.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
                for t in TABLES}


def test_both_updaters_record_the_same_rows(rig):
    """Both packages' updaters poll one served chain over the same rounds
    (three epochs with an empty slot, then two more slots): every table's
    rows are equal."""
    harness, server, db, updater = rig
    jdb = JWatchDB()
    jupdater = JWatchUpdater(client=JClient(server.url), db=jdb, spec=harness.spec)
    try:
        spe = harness.spec.slots_per_epoch
        harness.extend_chain(spe)
        harness.advance_slot()
        harness.extend_chain(spe * 2)
        assert updater.update() == jupdater.update()
        harness.extend_chain(2)
        assert updater.update() == jupdater.update() == 2
        ours, theirs = rows(db), rows(jdb)
        assert all(ours[t] for t in ("blocks", "skipped_slots", "attestation_performance",
                                     "block_packing", "block_rewards", "blockprint"))
        assert ours == theirs
    finally:
        jdb.close()
