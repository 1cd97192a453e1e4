"""watch: off-node chain analytics.

Equivalent of the reference's ``watch/`` crate (6.5k LoC — a PostgreSQL
updater + HTTP server tracking block packing, proposer activity, and
suboptimal attestations).  The host database here is stdlib sqlite3 (the
embedded analog of the reference's diesel/Postgres layer); the shape is the
same: an updater polls a beacon node over the standard HTTP API, a read-only
HTTP server exposes the aggregates.

A copy of the JAX package's ``lighthouse_tpu/watch/__init__.py``; the
updater polls through the port's ``BeaconNodeHttpClient``.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS blocks (
    slot INTEGER PRIMARY KEY,
    root TEXT NOT NULL,
    proposer INTEGER NOT NULL,
    attestation_count INTEGER NOT NULL,
    sync_participation REAL,
    graffiti TEXT
);
CREATE TABLE IF NOT EXISTS skipped_slots (
    slot INTEGER PRIMARY KEY
);
CREATE TABLE IF NOT EXISTS attestation_performance (
    epoch INTEGER NOT NULL,
    validator INTEGER NOT NULL,
    source INTEGER NOT NULL,
    target INTEGER NOT NULL,
    head INTEGER NOT NULL,
    PRIMARY KEY (epoch, validator)
);
CREATE TABLE IF NOT EXISTS block_packing (
    slot INTEGER PRIMARY KEY,
    available INTEGER NOT NULL,
    included INTEGER NOT NULL,
    prior_skip_slots INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS block_rewards (
    slot INTEGER PRIMARY KEY,
    total INTEGER NOT NULL,
    attestation_reward INTEGER NOT NULL,
    sync_committee_reward INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS blockprint (
    slot INTEGER PRIMARY KEY,
    best_guess TEXT NOT NULL
);
"""


class WatchDB:
    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def record_block(self, *, slot: int, root: bytes, proposer: int,
                     attestation_count: int, sync_participation: Optional[float],
                     graffiti: str = "") -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO blocks VALUES (?,?,?,?,?,?)",
                (slot, "0x" + bytes(root).hex(), proposer, attestation_count,
                 sync_participation, graffiti),
            )
            self._conn.commit()

    def record_skipped(self, slot: int) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR IGNORE INTO skipped_slots VALUES (?)", (slot,)
            )
            self._conn.commit()

    def record_block_packing(self, slot: int, available: int, included: int,
                             prior_skip_slots: int) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO block_packing VALUES (?,?,?,?)",
                (slot, available, included, prior_skip_slots),
            )
            self._conn.commit()

    def record_block_rewards(self, slot: int, total: int,
                             attestation_reward: int,
                             sync_committee_reward: int) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO block_rewards VALUES (?,?,?,?)",
                (slot, total, attestation_reward, sync_committee_reward),
            )
            self._conn.commit()

    def record_blockprint(self, slot: int, best_guess: str) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO blockprint VALUES (?,?)",
                (slot, best_guess),
            )
            self._conn.commit()

    def record_attestation_performance(self, epoch: int, rows: List[dict]) -> None:
        with self._lock:
            for r in rows:
                self._conn.execute(
                    "INSERT OR REPLACE INTO attestation_performance VALUES (?,?,?,?,?)",
                    (epoch, int(r["validator_index"]),
                     1 if int(r["source"]) > 0 else 0,
                     1 if int(r["target"]) > 0 else 0,
                     1 if int(r["head"]) > 0 else 0),
                )
            self._conn.commit()

    # ------------------------------------------------------------- queries

    def highest_slot(self) -> Optional[int]:
        with self._lock:
            row = self._conn.execute(
                "SELECT MAX(s) FROM (SELECT MAX(slot) AS s FROM blocks "
                "UNION SELECT MAX(slot) FROM skipped_slots)"
            ).fetchone()
        return row[0]

    def block_at(self, slot: int) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute(
                "SELECT slot, root, proposer, attestation_count, "
                "sync_participation, graffiti FROM blocks WHERE slot=?", (slot,)
            ).fetchone()
        if row is None:
            return None
        return {"slot": row[0], "root": row[1], "proposer": row[2],
                "attestation_count": row[3], "sync_participation": row[4],
                "graffiti": row[5]}

    def proposer_blocks(self, proposer: int) -> List[int]:
        with self._lock:
            return [r[0] for r in self._conn.execute(
                "SELECT slot FROM blocks WHERE proposer=? ORDER BY slot",
                (proposer,),
            )]

    def suboptimal_attestations(self, epoch: int) -> List[dict]:
        """Validators that missed any flag in ``epoch`` (the reference's
        suboptimal-attestation tracking)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT validator, source, target, head FROM "
                "attestation_performance WHERE epoch=? AND "
                "(source=0 OR target=0 OR head=0) ORDER BY validator",
                (epoch,),
            ).fetchall()
        return [{"validator": v, "source": bool(s), "target": bool(t),
                 "head": bool(h)} for v, s, t, h in rows]

    def block_packing(self, slot: int) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute(
                "SELECT slot, available, included, prior_skip_slots FROM "
                "block_packing WHERE slot=?", (slot,),
            ).fetchone()
        if row is None:
            return None
        avail = row[1]
        return {"slot": row[0], "available": avail, "included": row[2],
                "prior_skip_slots": row[3],
                "efficiency": (row[2] / avail) if avail else 0.0}

    def block_rewards(self, slot: int) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute(
                "SELECT slot, total, attestation_reward, "
                "sync_committee_reward FROM block_rewards WHERE slot=?",
                (slot,),
            ).fetchone()
        if row is None:
            return None
        return {"slot": row[0], "total": row[1],
                "attestation_reward": row[2],
                "sync_committee_reward": row[3]}

    def blockprint_at(self, slot: int) -> Optional[str]:
        with self._lock:
            row = self._conn.execute(
                "SELECT best_guess FROM blockprint WHERE slot=?", (slot,),
            ).fetchone()
        return row[0] if row else None

    def blockprint_summary(self) -> Dict[str, int]:
        """Client-diversity counts over all fingerprinted blocks
        (reference blockprint's aggregate view)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT best_guess, COUNT(*) FROM blockprint GROUP BY "
                "best_guess ORDER BY COUNT(*) DESC",
            ).fetchall()
        return {guess: n for guess, n in rows}

    def participation_rate(self, epoch: int) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute(
                "SELECT COUNT(*), SUM(source), SUM(target), SUM(head) FROM "
                "attestation_performance WHERE epoch=?", (epoch,),
            ).fetchone()
        if not row or not row[0]:
            return None
        n = row[0]
        return {"epoch": epoch, "validators": n,
                "source_rate": row[1] / n, "target_rate": row[2] / n,
                "head_rate": row[3] / n}

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def blockprint_guess(graffiti: str) -> str:
    """Heuristic client fingerprint from the block's visible shape.

    The reference's blockprint subsystem defers to an external ML service;
    offline, the strongest public signal is the graffiti convention each
    client ships by default."""
    g = graffiti.lower()
    for needle, name in (("lighthouse", "Lighthouse"), ("teku", "Teku"),
                         ("nimbus", "Nimbus"), ("prysm", "Prysm"),
                         ("lodestar", "Lodestar"), ("grandine", "Grandine")):
        if needle in g:
            return name
    return "Uncertain"


class WatchUpdater:
    """Poll a beacon node into the DB (reference watch's updater loop)."""

    def __init__(self, *, client, db: WatchDB, spec):
        self.client = client
        self.db = db
        self.spec = spec
        self._last_rewards_epoch: Optional[int] = None
        self._packing_frontier_epoch: int = 0

    def update(self) -> int:
        """One round: ingest new slots up to the node's head; pull
        attestation performance for newly completed epochs.  Returns the
        number of slots ingested."""
        head = self.client.block_header("head")
        head_slot = int(head["header"]["message"]["slot"])
        start = (self.db.highest_slot() or 0) + 1
        try:
            ingested, last_done = self._ingest_blocks(start, head_slot)
        finally:
            # Analytics must cover every slot that actually landed, even
            # when the block loop aborted mid-round (a transient error must
            # not leave a permanent packing/rewards gap).
            if last_done >= start:
                self._ingest_packing_and_rewards(start, last_done)
        self._maybe_pull_rewards_performance(head_slot)
        return ingested

    def _ingest_blocks(self, start: int, head_slot: int):
        from ..http_api.client import ApiClientError

        head = self.client.block_header("head")
        ingested = 0
        last_done = start - 1
        for slot in range(start, head_slot + 1):
            try:
                resp = self.client.block(str(slot))
            except ApiClientError as e:
                if e.code == 404:
                    self.db.record_skipped(slot)  # genuinely empty slot
                    last_done = slot
                    continue
                return ingested, last_done  # node-side error: retry next round
            except OSError:
                return ingested, last_done  # transient transport failure:
                                            # never record a live slot skipped
            msg = resp["data"]["message"]
            if int(msg["slot"]) != slot:
                self.db.record_skipped(slot)
                last_done = slot
                continue
            body = msg["body"]
            sync_part = None
            if "sync_aggregate" in body:
                bits = body["sync_aggregate"]["sync_committee_bits"]
                raw = bytes.fromhex(bits[2:])
                total = self.spec.preset.sync_committee_size
                ones = sum(bin(b).count("1") for b in raw)
                sync_part = min(1.0, ones / total)
            att_count = len(body.get("attestations", []))
            graffiti = body.get("graffiti", "")
            self.db.record_block(
                slot=slot,
                root=bytes.fromhex(head["root"][2:]) if slot == head_slot
                else self._root_for(slot),
                proposer=int(msg["proposer_index"]),
                attestation_count=att_count,
                sync_participation=sync_part,
                graffiti=graffiti,
            )
            self.db.record_blockprint(slot, blockprint_guess(graffiti))
            ingested += 1
            last_done = slot
        return ingested, last_done

    def _maybe_pull_rewards_performance(self, head_slot: int) -> None:
        spe = self.spec.slots_per_epoch
        completed_epoch = head_slot // spe - 2
        if completed_epoch >= 0 and completed_epoch != self._last_rewards_epoch:
            try:
                resp = self.client.post(
                    f"/eth/v1/beacon/rewards/attestations/{completed_epoch}", None
                )
                self.db.record_attestation_performance(
                    completed_epoch, resp["data"]["total_rewards"]
                )
                self._last_rewards_epoch = completed_epoch
            except Exception:
                pass  # rewards unavailable (pruned state): analytics are best-effort

    def _ingest_packing_and_rewards(self, start: int, end: int) -> None:
        """Best-effort packing + rewards pulls for the newly ingested span
        (reference watch's block_packing and block_rewards updaters)."""
        spe = self.spec.slots_per_epoch
        try:
            # Epoch-granular endpoint: only re-fetch from the frontier (the
            # last epoch may have been partial when previously pulled).
            start_epoch = min(start // spe, self._packing_frontier_epoch)
            resp = self.client.get(
                "/lighthouse/analysis/block_packing_efficiency"
                f"?start_epoch={start_epoch}&end_epoch={end // spe}"
            )
            for row in resp["data"]:
                self.db.record_block_packing(
                    int(row["slot"]), int(row["available_attestations"]),
                    int(row["included_attestations"]),
                    int(row["prior_skip_slots"]),
                )
            self._packing_frontier_epoch = end // spe
        except Exception:
            pass
        try:
            resp = self.client.get(
                f"/lighthouse/analysis/block_rewards?start_slot={max(1, start)}"
                f"&end_slot={end}"
            )
            for row in resp["data"]:
                self.db.record_block_rewards(
                    int(row["slot"]), int(row["total"]),
                    int(row["attestations"]), int(row["sync_aggregate"]),
                )
        except Exception:
            pass

    def _root_for(self, slot: int) -> bytes:
        return self.client.block_root(str(slot))


class WatchServer:
    """Read-only analytics API over the DB (reference watch's HTTP server)."""

    def __init__(self, db: WatchDB, port: int = 0):
        self.db = db
        self._port = port
        self._server: Optional[ThreadingHTTPServer] = None

    def start(self) -> "WatchServer":
        db = self.db

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                try:
                    if parts[:2] == ["v1", "slots"] and len(parts) == 3:
                        row = db.block_at(int(parts[2]))
                        if row is None:
                            self._reply(404, {"message": "no block at that slot"})
                        else:
                            self._reply(200, {"data": row})
                        return
                    if parts[:2] == ["v1", "proposers"] and len(parts) == 3:
                        self._reply(200, {"data": db.proposer_blocks(int(parts[2]))})
                        return
                    if parts[:2] == ["v1", "participation"] and len(parts) == 3:
                        row = db.participation_rate(int(parts[2]))
                        if row is None:
                            self._reply(404, {"message": "epoch not ingested"})
                        else:
                            self._reply(200, {"data": row})
                        return
                    if parts[:2] == ["v1", "packing"] and len(parts) == 3:
                        row = db.block_packing(int(parts[2]))
                        if row is None:
                            self._reply(404, {"message": "no packing data"})
                        else:
                            self._reply(200, {"data": row})
                        return
                    if parts[:2] == ["v1", "rewards"] and len(parts) == 3:
                        row = db.block_rewards(int(parts[2]))
                        if row is None:
                            self._reply(404, {"message": "no rewards data"})
                        else:
                            self._reply(200, {"data": row})
                        return
                    if parts[:2] == ["v1", "blockprint"] and len(parts) == 3:
                        if parts[2] == "summary":
                            self._reply(200, {"data": db.blockprint_summary()})
                            return
                        guess = db.blockprint_at(int(parts[2]))
                        if guess is None:
                            self._reply(404, {"message": "no blockprint"})
                        else:
                            self._reply(200, {"data": {"best_guess": guess}})
                        return
                    if (parts[:2] == ["v1", "suboptimal_attestations"]
                            and len(parts) == 3):
                        self._reply(
                            200, {"data": db.suboptimal_attestations(int(parts[2]))}
                        )
                        return
                except ValueError:
                    self._reply(400, {"message": "bad parameter"})
                    return
                self._reply(404, {"message": "unknown route"})

        self._server = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
