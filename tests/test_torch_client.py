"""The port's node assembly (``client/``) and ``python -m
lighthouse_tpu_torch bn`` vs the JAX package's.

- The JAX package's ``test_discovery.py::test_client_builder_joins_network``
  and ``::test_checkpoint_sync_from_url_then_backfill`` re-pointed at the
  port, the builder on the CPU (``with_device("cpu")``);
- the CLI: ``bn --device cpu`` boots an interop node that answers
  ``/eth/v1/node/health`` and exits 0 on SIGTERM; ``bn`` without
  ``--device`` exits non-zero before serving where there is no card, its
  error naming the missing card;
- the state-advance fault of the JAX package (``prepare_next_slot`` has no
  distance guard): with the clock 40 slots past the head the JAX package
  advances a state to the clock, the port (as Lighthouse's
  ``state_advance_timer.rs``, ``MAX_ADVANCE_DISTANCE`` = 4) does nothing;
  1 to 4 slots behind, both advance to the same state;
- the peer routes: a JAX builder-assembled node's API counts no peer
  whatever it is connected to (the builder never hands it the network's
  peer manager), and given one its ``/eth/v1/node/peer_count`` answers 500
  (it calls ``peers()`` on a dict); the port's counts its peers;
- the two limits a node that boots from an old anchor meets in both
  packages, each with the same answer from both: an attestation of the
  anchor's epoch POSTed with the clock far ahead raises the fork-choice
  error out of the pool route (HTTP 500, the rest of the body unprocessed);
  with no KZG engine (as the builder leaves it) a gossip blob fails its
  availability check, and a block imported with its sidecars takes them
  unchecked;
- (slow) ``chip_smoke``'s ``[client]`` on the CPU: a 4,096-validator node
  started through the CLI with ``--device cpu`` on a checkpoint-synced
  node's post-state, every gate.

Chains run on the port's CPU routes (host tree hashing, the numpy epoch
backend) with fake crypto unless a test says otherwise.  Every comparison
is exact.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu.chain import beacon_chain as j_bc  # noqa: E402
from lighthouse_tpu.client import ClientBuilder as JClientBuilder  # noqa: E402
from lighthouse_tpu.crypto.bls import backends as jbackends  # noqa: E402
from lighthouse_tpu.http_api import HttpApiServer as JServer  # noqa: E402
from lighthouse_tpu.network.tcp_transport import TcpEndpoint as JTcpEndpoint  # noqa: E402
from lighthouse_tpu.types.spec import minimal_spec as j_minimal_spec  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.chain import beacon_chain as p_bc  # noqa: E402
from lighthouse_tpu_torch.client import ClientBuilder  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.http_api import HttpApiServer  # noqa: E402
from lighthouse_tpu_torch.http_api.serde import to_json  # noqa: E402
from lighthouse_tpu_torch.network.boot_node import BootNode  # noqa: E402
from lighthouse_tpu_torch.network.node import LocalNode  # noqa: E402
from lighthouse_tpu_torch.network.tcp_transport import TcpEndpoint  # noqa: E402
from lighthouse_tpu_torch.types.spec import minimal_spec  # noqa: E402
from test_torch_chain import harnesses, jax_backend, port_cpu  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
GENESIS_TIME = 1_600_000_000
#: The CLI node's seconds to come up (importing torch, an interop genesis
#: of 64 validators) and to stop.
BOOT_S = 120.0
STOP_S = 30.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tcp_node(peer_id: str):
    harness = BeaconChainHarness(validator_count=16, fake_crypto=True,
                                 genesis_time=GENESIS_TIME)
    return LocalNode(peer_id=peer_id, harness=harness, endpoint=TcpEndpoint(peer_id))


def _wait(condition, timeout: float) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if condition():
            return True
        time.sleep(0.1)
    return condition()


def _get(url: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


# ---------------------------------------- the JAX package's test_discovery


def test_client_builder_joins_network():
    """A ClientBuilder-assembled node joins the fabric via a boot node and
    syncs to an existing TCP node — the CLI `bn --boot-nodes` path."""
    set_backend("fake")
    boot = BootNode()
    synced = _tcp_node("synced-cb")
    client = None
    try:
        synced.harness.extend_chain(4)
        synced.endpoint.dial(*boot.listen_addr)
        client = (
            ClientBuilder()
            .with_device("cpu")
            .with_spec(synced.harness.spec)
            .with_genesis_state(synced.harness.chain.genesis_state)
            .with_bls_backend("fake")
            .with_network(boot_nodes=[f"{boot.listen_addr[0]}:{boot.listen_addr[1]}"])
            .build()
        )
        # the client's SystemTimeSlotClock is far past genesis_time=1.6e9,
        # so future-slot checks pass
        client.start()
        assert _wait(lambda: client.chain.head_root == synced.chain.head_root, 10)
        assert "synced-cb" in client.network_node.endpoint.connected_peers()
    finally:
        if client is not None:
            client.stop()
        synced.shutdown()
        boot.stop()


def test_checkpoint_sync_from_url_then_backfill():
    """The reference's weak-subjectivity boot over HTTP: a fresh builder node
    fetches the finalized (block, state) pair as SSZ from a trusted node's
    API, anchors there, then backfills history over p2p."""
    set_backend("fake")
    source = _tcp_node("cp-src")
    server = HttpApiServer(source.chain).start()
    client = None
    try:
        spe = source.harness.spec.slots_per_epoch
        source.harness.extend_chain(spe * 5)  # establish finality
        f_epoch, f_root = source.chain.finalized_checkpoint()
        assert f_epoch >= 2
        host, port = source.endpoint.listen_addr
        client = (
            ClientBuilder()
            .with_device("cpu")
            .with_spec(source.harness.spec)
            .with_bls_backend("fake")
            .with_checkpoint_sync(server.url)
            .with_network(peers=[f"{host}:{port}"])
            .build()
        )
        chain_b = client.chain
        assert chain_b.genesis_block_root == f_root
        assert chain_b.anchor_slot > 0
        # start() dials the peer AND launches backfill
        client.start()
        target = source.chain.block_root_at_slot(1)
        assert _wait(lambda: chain_b.db.get_block(target) is not None, 20), (
            "automatic backfill did not reach genesis history")
    finally:
        if client is not None:
            client.stop()
        server.stop()
        source.shutdown()


# ----------------------------------------------------------------- the CLI


def test_bn_on_the_cpu_answers_health_and_stops_on_sigterm(tmp_path):
    log_path = tmp_path / "bn.log"
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "lighthouse_tpu_torch", "bn", "--device", "cpu",
             "--interop-validators", "64", "--network", "minimal", "--http-port", "0",
             "--datadir", str(tmp_path / "db")],
            stdout=log, stderr=subprocess.STDOUT, cwd=str(REPO),
            env=dict(os.environ, PYTHONUNBUFFERED="1"))
    try:
        port = None

        def up():
            nonlocal port
            m = re.search(r"beacon node up: http API on :(\d+)", log_path.read_text())
            port = m and int(m.group(1))
            return port is not None or proc.poll() is not None

        assert _wait(up, BOOT_S) and port, log_path.read_text()[-2000:]
        assert "device=cpu" in log_path.read_text()
        status, _ = _get(f"http://127.0.0.1:{port}/eth/v1/node/health")
        assert status in (200, 206)  # synced, or syncing after an empty slot
        status, version = _get(f"http://127.0.0.1:{port}/eth/v1/node/version")
        assert status == 200 and version["data"]["version"].startswith("lighthouse-tpu/")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=STOP_S) == 0, log_path.read_text()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_bn_without_a_card_exits_before_serving(tmp_path):
    """``bn`` runs on the card by default; here, with no card, it exits
    non-zero before anything is served, and says why."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    res = subprocess.run(
        [sys.executable, "-m", "lighthouse_tpu_torch", "bn", "--interop-validators", "64",
         "--network", "minimal", "--http-port", str(port)],
        capture_output=True, text=True, cwd=str(REPO), timeout=BOOT_S)
    assert res.returncode != 0
    assert "beacon node up" not in res.stdout
    assert "no CUDA card" in res.stderr and "--device cpu" in res.stderr
    assert "torch.cuda.is_available() is False" in res.stderr
    with socket.socket() as s:
        assert s.connect_ex(("127.0.0.1", port)) != 0


# ------------------------------------------------------- the state advance


def _advance_pair(behind: int):
    jhs, phs = harnesses({}, validators=16)
    with jax_backend("fake"):
        jhs.extend_chain(2)
    phs.extend_chain(2)
    assert jhs.chain.head_root == phs.chain.head_root
    for hs in (jhs, phs):
        hs.chain.slot_clock.set_slot(hs.chain.head_slot() + behind)
    return jhs.chain, phs.chain


def test_state_advance_far_behind_the_clock_jax_advances_port_refuses():
    """The JAX package's fault (ROADMAP C2): 40 slots behind the clock its
    ``prepare_next_slot`` processes every slot to the clock; the port's
    returns False and caches nothing, as Lighthouse does past
    ``MAX_ADVANCE_DISTANCE``."""
    jchain, pchain = _advance_pair(40)
    head_slot = pchain.head_slot()
    with jax_backend("fake"):
        assert jchain.prepare_next_slot() is True
    assert jchain._advanced[1] == head_slot + 41
    assert int(jchain._advanced[2].slot) == head_slot + 41
    assert pchain.prepare_next_slot() is False
    assert pchain._advanced is None
    assert not hasattr(j_bc, "MAX_ADVANCE_DISTANCE") and p_bc.MAX_ADVANCE_DISTANCE == 4


@pytest.mark.parametrize("behind", [1, 2, 3, 4])
def test_state_advance_near_the_clock_matches_jax(behind):
    jchain, pchain = _advance_pair(behind)
    with jax_backend("fake"):
        assert jchain.prepare_next_slot() is True
    assert pchain.prepare_next_slot() is True
    assert pchain._advanced[:2] == jchain._advanced[:2]
    assert pchain._advanced[1] == pchain.head_slot() + behind + 1
    assert pchain._advanced[2].as_ssz_bytes() == jchain._advanced[2].as_ssz_bytes()


# --------------------------------------------------------- the peer routes


def _builder_node(builder_cls, spec):
    return (builder_cls().with_spec(spec)
            .with_interop_genesis(16, genesis_time=GENESIS_TIME)
            .with_bls_backend("fake").with_http_api(0).with_network(listen_port=0))


def test_builder_node_counts_its_peers_where_the_jax_one_counts_none():
    schedule = dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
                    deneb_fork_epoch=None)
    j_prev = jbackends.backend_name()
    counts, nodes, peers = {}, [], []
    try:
        for name, builder, endpoint_cls in (
                ("jax", _builder_node(JClientBuilder, j_minimal_spec(**schedule)),
                 JTcpEndpoint),
                ("port", _builder_node(ClientBuilder, minimal_spec(**schedule))
                 .with_device("cpu"), TcpEndpoint)):
            client = builder.build().start()
            nodes.append(client)
            peer = endpoint_cls(f"peer-{name}")
            peers.append(peer)
            peer.dial(*client.network_node.endpoint.listen_addr)
            assert _wait(lambda: client.network_node.service.peer_manager
                         .connected_peers() == [f"peer-{name}"], 10)
            url = client.http_server.url
            counts[name] = (_get(url + "/eth/v1/node/peer_count"),
                            _get(url + "/eth/v1/node/peers"),
                            _get(url + "/eth/v1/node/identity")[1]["data"]["peer_id"])
        jnode, pnode = nodes
        assert counts["jax"][0] == (200, {"data": {
            "connected": "0", "connecting": "0", "disconnected": "0", "disconnecting": "0"}})
        assert counts["jax"][1] == (200, {"data": [], "meta": {"count": 0}})
        assert counts["jax"][2] == ""
        assert counts["port"][0][1]["data"]["connected"] == "1"
        assert [p["peer_id"] for p in counts["port"][1][1]["data"]] == ["peer-port"]
        assert counts["port"][1][1]["data"][0]["state"] == "connected"
        assert counts["port"][2] == pnode.network_node.peer_id
        # the JAX package's routes given its own peer manager
        jnode.http_server.peer_manager = jnode.network_node.service.peer_manager
        status, body = _get(jnode.http_server.url + "/eth/v1/node/peer_count")
        assert status == 500 and "not callable" in body["message"]
    finally:
        for client in nodes:
            client.stop()
            client.network_node.endpoint.close()
        for peer in peers:
            peer.close()
        jbackends.set_backend(j_prev)


# ------------------------------------ the two limits of an old anchor


def test_attestation_far_behind_the_clock_fails_alike():
    """Two attestations of the head's slot POSTed with the clock 1,000
    epochs ahead: fork choice refuses the first one's target epoch, and its
    error is not one the pool route catches, in both packages: HTTP 500 with
    the same message, nothing pooled, the second attestation never
    processed."""
    import urllib.error
    import urllib.request

    from lighthouse_tpu.consensus import helpers as jh
    from lighthouse_tpu.http_api.serde import to_json as j_to_json
    from lighthouse_tpu_torch.consensus import helpers as ph

    jhs, phs = harnesses({}, validators=16)
    with jax_backend("fake"):
        jhs.extend_chain(2)
    phs.extend_chain(2)
    answers = {}
    for name, hs, helpers, server_cls, to_js in (
            ("jax", jhs, jh, JServer, j_to_json), ("port", phs, ph, HttpApiServer, to_json)):
        chain = hs.chain
        slot, state = chain.head_slot(), chain.head_state
        with jax_backend("fake"):
            data = chain.produce_attestation_data(slot, 0)
            committee = [int(v) for v in helpers.get_beacon_committee(state, slot, 0, hs.spec)]
            body = []
            for pos in range(2):
                sig = hs.sign_attestation_data(state, data, committee[pos]).to_bytes()
                body.append(to_js(hs.types.Attestation(
                    aggregation_bits=[i == pos for i in range(len(committee))], data=data,
                    signature=sig)))
        chain.slot_clock.set_slot(slot + 1000 * hs.spec.slots_per_epoch)
        pooled = len(chain.attestation_pool._pool)
        server = server_cls(chain).start()
        try:
            req = urllib.request.Request(
                server.url + "/eth/v1/beacon/pool/attestations", method="POST",
                data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
            with jax_backend("fake"):
                try:
                    urllib.request.urlopen(req, timeout=30)
                    answers[name] = (200, None)
                except urllib.error.HTTPError as e:
                    answers[name] = (e.code, json.loads(e.read()))
        finally:
            server.stop()
        answers[name] += (len(chain.attestation_pool._pool) - pooled,)
    assert answers["jax"] == answers["port"]
    status, reply, pooled = answers["port"]
    assert status == 500 and "target epoch" in reply["message"] and pooled == 0


def test_blobs_without_kzg_alike():
    """A chain with no KZG engine (the builder's default; the CLI has no
    flag for a trusted setup), in both packages alike: a gossip sidecar
    (the router's ``da_checker.put_blob``) fails its availability check
    ("no KZG engine configured"), while a block imported with its sidecars
    (``process_block_with_blobs``: the API and range-sync path) takes the
    blobs without any KZG check and becomes the head (ROADMAP C2)."""
    import dataclasses

    from lighthouse_tpu.crypto.kzg import Kzg as JKzg
    from lighthouse_tpu.crypto.kzg import TrustedSetup as JTrustedSetup
    from lighthouse_tpu_torch.crypto.kzg import Kzg, TrustedSetup
    from lighthouse_tpu_torch.types.spec import MINIMAL_PRESET

    width = 64
    preset = dataclasses.replace(MINIMAL_PRESET, field_elements_per_blob=width)
    deneb = dict(preset=preset, altair_fork_epoch=0, bellatrix_fork_epoch=0,
                 capella_fork_epoch=0, deneb_fork_epoch=0)
    jhs, phs = harnesses(deneb, validators=16)
    jhs.chain.kzg = JKzg(JTrustedSetup.insecure_dev_setup(width=width))
    phs.chain.kzg = Kzg(TrustedSetup.insecure_dev_setup(width=width), device="cpu")
    blob = b"".join((j % 251).to_bytes(32, "big") for j in range(width))
    outcomes = []
    for hs in (jhs, phs):
        with jax_backend("fake"):
            hs.advance_slot()
            signed, sidecars = hs.produce_signed_block_with_blobs([blob])
            hs.chain.kzg = hs.chain.da_checker.kzg = None
            with pytest.raises(Exception) as info:
                hs.chain.da_checker.put_blob(sidecars[0])
            root = hs.chain.process_block_with_blobs(signed, sidecars)
        outcomes.append((type(info.value).__name__, str(info.value), root,
                         hs.chain.head_root == root,
                         [sc.as_ssz_bytes() for sc in hs.chain.get_blobs(root)]))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][:2] == ("BlobError", "no KZG engine configured")
    assert outcomes[1][3] is True and outcomes[1][4] == [sidecars[0].as_ssz_bytes()]


# ------------------------------------------- the [client] phase on the CPU


@pytest.mark.slow
def test_chip_smoke_client_phase_on_cpu(tmp_path):
    """``chip_smoke``'s ``[client]`` on the CPU: a 4,096-validator block
    import case (no blobs) imported by a checkpoint-synced node, a double
    vote's slashing pooled, then the node started through the CLI with
    ``--device cpu`` on the post-state, and every gate."""
    import chip_smoke
    from lighthouse_tpu_torch import workload
    from lighthouse_tpu_torch.chain import BeaconChain, ManualSlotClock
    from lighthouse_tpu_torch.chain.mock_el import MockExecutionEngine
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.types.spec import DOMAIN_BEACON_ATTESTER
    from lighthouse_tpu_torch.workload import _Signer

    set_backend("torch")
    case = workload.block_import_case(4096, seed=0xB10C, blob_commitments=[])
    workload.warm_pubkey_cache(case.keys)
    signed, spec, types = case.signed_block, case.spec, case.types
    clock = ManualSlotClock(int(case.pre_state.genesis_time), spec.seconds_per_slot)
    clock.set_slot(int(signed.message.slot))
    chain = BeaconChain(genesis_state=case.pre_state, types=types, spec=spec,
                        slot_clock=clock, execution_engine=MockExecutionEngine())
    chain.process_block(signed)

    # a double vote of a keyed member of slot S+1, as [network]'s
    state, sk = chain.head_state, case.keys.secret
    slot = int(state.slot) + 1
    epoch = h.compute_epoch_at_slot(slot, spec)
    committee = [int(v) for v in h.get_beacon_committee(state, slot, 0, spec)]
    voter = next(v for v in committee if v in sk)
    target = types.Checkpoint(epoch=epoch, root=h.get_block_root(state, epoch, spec))
    domain = h.get_domain(state, DOMAIN_BEACON_ATTESTER, epoch, spec)
    indexed = []
    for vote_head in (chain.head_root, chain.genesis_block_root):
        data = types.AttestationData(slot=slot, index=0, beacon_block_root=vote_head,
                                     source=state.current_justified_checkpoint.copy(),
                                     target=target.copy())
        bits = [v == voter for v in committee]
        att = types.Attestation(aggregation_bits=bits, data=data, signature=_Signer().sign(
            h.compute_signing_root(data.hash_tree_root(), domain), sk[voter]))
        indexed.append(h.get_indexed_attestation(state, att, types, spec))
    slashing = types.AttesterSlashing(attestation_1=indexed[0], attestation_2=indexed[1])
    assert chain.on_gossip_attester_slashing(slashing)

    served = chip_smoke.api_server(chain)
    try:
        with pytest.MonkeyPatch.context() as mp:
            # the plain versions' 128 x 32 verify takes minutes: warm 2 x 1
            mp.setattr(chip_smoke, "CLIENT_WARMUP_BUCKETS", "2x1")
            cell = chip_smoke.ClientCell("cpu", chain, served, case.host_state.as_ssz_bytes(),
                                         chain.op_pool.attester_slashings()[0], spec,
                                         device="cpu")
            out = cell.finish()
    finally:
        served[0].stop()
        served[1].shutdown()
    assert out["warmup"]["2x1"]["outcome"] in ("hit", "miss")
    assert [r["verdict"] for r in out["records"]] == [False, True]
    assert out["ops"]["tree_hash"] > 0
    assert out["stop_s"] < chip_smoke.CLIENT_STOP_S
