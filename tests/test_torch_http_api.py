"""The port's Beacon API (``http_api/``: server, client, task spawner,
response cache) vs the JAX package's.

- The JAX package's ``test_http_api.py`` re-pointed at the port: a harness
  chain served over real TCP, driven end to end (produce, sign, publish)
  through the port's typed client;
- the HTTP-route cases of the JAX package's ``test_builder.py`` (blinded
  blocks through ``/eth/v3/validator/blocks``, driven by the port's
  ``ValidatorClient``) and ``test_light_client.py``; the JAX package's
  ``ValidatorClient`` and the port's send the port's node the same
  requests for the same slot;
- the route table: the port's ``ROUTES`` is the JAX package's, all 122
  routes in the same order, and the cached routes declare the same topics;
  ``GET /lighthouse/autotune`` answers 200 with the JAX body's keys (and
  the port's ``walk_lookahead``);
- interop: the port's client reads the JAX package's server, the JAX
  package's client the port's;
- parity: one harness schedule in both packages, each chain served by its
  own package's server, the same requests to both (one at least for every
  route the JAX package's tests call).  JSON bodies are equal after
  ``json.loads``, SSZ bodies byte for byte.  Exempted: the version string,
  the peer id and the ENR (``EXEMPT``).  The routes that report on the
  process rather than the chain (``PROCESS_ROUTES``: the host's health,
  traces, device telemetry, fault points, the cache and admission state,
  the black box) are compared by their keys, and ``/metrics`` by its HTTP
  API families.

Chains run on the port's CPU routes (host tree hashing, the numpy epoch
backend) with fake crypto unless a test says otherwise.
"""

import http.client
import json
import threading
import time
import urllib.request

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu.chain import BeaconChainHarness as JHarness  # noqa: E402
from lighthouse_tpu.crypto.bls import backends as jbackends  # noqa: E402
from lighthouse_tpu.http_api import BeaconNodeHttpClient as JClient  # noqa: E402
from lighthouse_tpu.http_api import HttpApiServer as JServer  # noqa: E402
from lighthouse_tpu.http_api import server as jserver  # noqa: E402
from lighthouse_tpu_torch.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu_torch.consensus import helpers as h  # noqa: E402
from lighthouse_tpu_torch.consensus import per_epoch as pe  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import backends as pbackends  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend, torch_backend  # noqa: E402
from lighthouse_tpu_torch.execution_layer.builder_client import (  # noqa: E402
    BuilderHttpClient,
    MockRelay,
)
from lighthouse_tpu_torch.http_api import (  # noqa: E402
    ApiClientError,
    BeaconNodeHttpClient,
    HttpApiServer,
)
from lighthouse_tpu_torch.http_api import server as pserver  # noqa: E402
from lighthouse_tpu_torch.http_api.serde import container_from_json  # noqa: E402
from lighthouse_tpu_torch.ops import tree_hash as th  # noqa: E402
from lighthouse_tpu_torch.scheduler import BeaconProcessor  # noqa: E402
from test_torch_chain import harnesses, specs  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
def port_cpu_module():
    """The port's CPU routes for the whole module (its served chains live
    across tests): host tree hashing, the numpy epoch backend, the
    ``"torch"`` BLS backend on the CPU; the JAX package's backend and the
    port's card defaults come back afterwards."""
    j_prev = jbackends.backend_name()
    th.configure(enabled=False)
    pe.configure(backend="numpy")
    torch_backend.configure(device="cpu")
    yield
    jbackends.set_backend(j_prev)
    pbackends._ACTIVE = pbackends._NAME = None
    torch_backend.reset_for_tests()
    pe.reset_for_tests()
    th.reset_for_tests()


@pytest.fixture(scope="module")
def served():
    set_backend("fake")
    harness = BeaconChainHarness(validator_count=16, fake_crypto=True)
    harness.extend_chain(4)
    processor = BeaconProcessor(max_workers=2)
    server = HttpApiServer(harness.chain, processor=processor).start()
    client = BeaconNodeHttpClient(server.url)
    yield harness, server, client
    server.stop()
    processor.shutdown()
    set_backend("host")


# ------------------------------------------- the JAX package's test_http_api


def test_node_endpoints(served):
    harness, server, client = served
    assert client.node_version().startswith("lighthouse-tpu/")
    syncing = client.node_syncing()
    assert syncing["head_slot"] == str(harness.chain._blocks_slot(harness.head_root))
    assert syncing["is_syncing"] is False
    assert client.node_health_ok()


def test_genesis_and_state_endpoints(served):
    harness, server, client = served
    g = client.genesis()
    assert g["genesis_time"] == str(harness.chain.genesis_time)
    assert g["genesis_validators_root"] == "0x" + harness.chain.genesis_validators_root.hex()

    fork = client.state_fork("head")
    assert fork["current_version"].startswith("0x")

    root = client.state_root("head")
    assert root == harness.head_state.hash_tree_root()

    fc = client.finality_checkpoints("head")
    assert int(fc["finalized"]["epoch"]) >= 0


def test_validators_endpoint(served):
    harness, server, client = served
    vals = client.validators("head")
    assert len(vals) == 16
    assert vals[0]["status"] == "active_ongoing"
    one = client.validators("head", ids=["3"])
    assert len(one) == 1 and one[0]["index"] == "3"
    # by pubkey
    pk = one[0]["validator"]["pubkey"]
    by_pk = client.validators("head", ids=[pk])
    assert by_pk[0]["index"] == "3"


def test_headers_and_blocks(served):
    harness, server, client = served
    head = client.block_header("head")
    assert head["root"] == "0x" + harness.head_root.hex()
    assert head["canonical"] is True

    blk = client.block("head")
    assert blk["data"]["message"]["slot"] == head["header"]["message"]["slot"]
    assert client.block_root("head") == harness.head_root

    by_slot = client.block_header(head["header"]["message"]["slot"])
    assert by_slot["root"] == head["root"]

    with pytest.raises(ApiClientError) as e:
        client.block("0x" + "ab" * 32)
    assert e.value.status == 404


def test_duties(served):
    harness, server, client = served
    spec = harness.spec
    epoch = harness.chain.current_slot() // spec.slots_per_epoch
    duties = client.proposer_duties(epoch)
    assert len(duties["data"]) == spec.slots_per_epoch
    assert all(d["pubkey"].startswith("0x") for d in duties["data"])

    att = client.attester_duties(epoch, list(range(16)))
    # every active validator attests exactly once per epoch
    assert len(att["data"]) == 16
    d0 = att["data"][0]
    assert int(d0["committee_length"]) > 0
    assert int(d0["validator_committee_index"]) < int(d0["committee_length"])


def test_proposer_duties_match_per_slot_computation(served):
    """Every duty entry must name the proposer the chain itself would pick at
    that slot."""
    harness, server, client = served
    spec = harness.spec
    epoch = harness.chain.current_slot() // spec.slots_per_epoch
    duties = client.proposer_duties(epoch)["data"]
    for d in duties:
        slot = int(d["slot"])
        state, _ = harness.chain.state_at_slot(max(slot, harness.chain.current_slot()))
        expected = h.get_beacon_proposer_index(state, spec, slot=slot)
        assert int(d["validator_index"]) == expected, f"slot {slot}"


def test_historical_state_by_slot(served):
    """GET /states/<past slot>/root resolves instead of 500ing."""
    harness, server, client = served
    root = client.state_root("2")
    blk_root = harness.chain.block_root_at_slot(2)
    st = harness.chain.get_state(blk_root)
    assert root == st.hash_tree_root()


def test_produce_sign_publish_roundtrip(served):
    """The core VC loop over the wire: duties → produce → sign → publish."""
    harness, server, client = served
    chain = harness.chain
    slot = harness.advance_slot()
    state, _ = chain.state_at_slot(slot)
    proposer = h.get_beacon_proposer_index(state, harness.spec)
    reveal = harness.randao_reveal(state, slot, proposer)

    resp = client.produce_block(slot, reveal)
    fork = resp["version"]
    block = container_from_json(harness.types.block[fork], resp["data"])
    assert int(block.slot) == slot
    signed = harness.sign_block(block, state)

    client.publish_block(signed)
    assert chain.head_root == block.hash_tree_root()


def test_attestation_flow(served):
    """attestation_data → sign → submit to pool → aggregate visible."""
    harness, server, client = served
    chain = harness.chain
    slot = harness.advance_slot()  # fresh slot: no harness attestations yet

    data = client.attestation_data(slot, 0, types=harness.types)
    assert int(data.slot) == slot

    state, _ = chain.state_at_slot(slot)
    committee = h.get_beacon_committee(state, slot, 0, harness.spec)
    vidx = int(committee[0])
    sig = harness.sign_attestation_data(state, data, vidx)
    bits = [False] * len(committee)
    bits[0] = True
    att = harness.types.Attestation(
        aggregation_bits=bits, data=data, signature=sig.to_bytes()
    )
    client.submit_attestations([att])

    agg = client.aggregate_attestation(slot, data.hash_tree_root(), types=harness.types)
    assert list(agg.aggregation_bits) == bits


def test_pool_rejects_bad_attestation(served):
    harness, server, client = served
    data = harness.chain.produce_attestation_data(harness.chain.current_slot(), 0)
    bad = harness.types.Attestation(
        aggregation_bits=[True],
        data=harness.types.AttestationData(
            slot=data.slot,
            index=data.index,
            beacon_block_root=b"\xee" * 32,  # unknown head
            source=data.source,
            target=data.target,
        ),
        signature=b"\x00" * 96,
    )
    with pytest.raises(ApiClientError) as e:
        client.submit_attestations([bad])
    assert e.value.status == 400


def test_config_and_debug(served):
    harness, server, client = served
    spec_json = client.config_spec()
    assert spec_json["SECONDS_PER_SLOT"] == str(harness.spec.seconds_per_slot)
    assert spec_json["PRESET_BASE"] == harness.spec.preset.name

    sched = client.get("/eth/v1/config/fork_schedule")["data"]
    assert sched[0]["previous_version"] == "0x" + harness.spec.genesis_fork_version.hex()

    heads = client.get("/eth/v1/debug/beacon/heads")["data"]
    assert any(hd["root"] == "0x" + harness.head_root.hex() for hd in heads)


def test_metrics_endpoint(served):
    harness, server, client = served
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=5)
    conn.request("GET", "/metrics")
    resp = conn.getresponse()
    text = resp.read().decode()
    conn.close()
    assert resp.status == 200
    assert "beacon_block_import_seconds" in text
    assert "http_api_requests_total" in text


def test_events_sse(served):
    harness, server, client = served
    received = []
    ready = threading.Event()

    def listen():
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
        conn.request("GET", "/eth/v1/events?topics=block,head")
        resp = conn.getresponse()
        ready.set()
        buf = b""
        while len(received) < 2:
            chunk = resp.read1(4096)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                received.append(frame.decode())
        conn.close()

    t = threading.Thread(target=listen, daemon=True)
    t.start()
    assert ready.wait(5)
    time.sleep(0.3)  # subscription registered after response headers
    harness.extend_chain(1)
    t.join(timeout=10)
    assert any("event: block" in f for f in received)
    block_frames = [f for f in received if "event: block" in f]
    assert f'"0x{harness.head_root.hex()}"' in block_frames[-1]


def test_ssz_block_and_state_negotiation(served):
    """Accept: application/octet-stream returns the raw SSZ with the
    consensus-version header, round-trippable into the same object; SSZ
    uploads publish through the octet-stream content type."""
    harness, server, client = served
    harness.extend_chain(1)
    head = harness.chain.get_block(harness.chain.head_root)
    fork = type(head.message).fork_name

    req = urllib.request.Request(
        f"{server.url}/eth/v2/beacon/blocks/head",
        headers={"Accept": "application/octet-stream"},
    )
    with urllib.request.urlopen(req, timeout=5) as resp:
        assert resp.headers["Content-Type"] == "application/octet-stream"
        assert resp.headers["Eth-Consensus-Version"] == fork
        raw = resp.read()
    decoded = harness.types.signed_block[fork].from_ssz_bytes(raw)
    assert decoded.message.hash_tree_root() == harness.chain.head_root

    req = urllib.request.Request(
        f"{server.url}/eth/v2/debug/beacon/states/head",
        headers={"Accept": "application/octet-stream"},
    )
    with urllib.request.urlopen(req, timeout=5) as resp:
        raw_state = resp.read()
    st = harness.types.state[fork].from_ssz_bytes(raw_state)
    assert st.hash_tree_root() == harness.chain.head_state.hash_tree_root()

    signed = harness.produce_signed_block(slot=harness.advance_slot())
    req = urllib.request.Request(
        f"{server.url}/eth/v2/beacon/blocks",
        data=signed.as_ssz_bytes(),
        method="POST",
        headers={"Content-Type": "application/octet-stream",
                 "Eth-Consensus-Version": type(signed.message).fork_name},
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert resp.status == 200
    assert harness.chain.head_root == signed.message.hash_tree_root()


def test_r4_standard_api_additions(served):
    """Blinded block by id, pool bls changes, expected withdrawals, v2
    block production, POST balances, deposit snapshot 404."""
    harness, server, client = served
    chain = harness.chain

    out = client.get("/eth/v1/beacon/blinded_blocks/head")
    fork = out["version"]
    blinded = container_from_json(
        harness.types.signed_blinded_block[fork], out["data"])
    assert blinded.message.hash_tree_root() == chain.head_root

    assert client.get("/eth/v1/beacon/pool/bls_to_execution_changes")["data"] == []

    w = client.get("/eth/v1/builder/states/head/expected_withdrawals")
    assert isinstance(w["data"], list)

    slot = chain.current_slot() + 1
    state, _ = chain.state_at_slot(slot)
    proposer = h.get_beacon_proposer_index(state, harness.spec)
    reveal = harness.randao_reveal(state, slot, proposer)
    v2 = client.get(
        f"/eth/v2/validator/blocks/{slot}?randao_reveal=0x{reveal.hex()}")
    assert "execution_payload" in v2["data"]["body"]

    bal = client.post("/eth/v1/beacon/states/head/validator_balances",
                      {"ids": ["0", "3"]})
    assert len(bal["data"]) == 2

    with pytest.raises(ApiClientError) as e:
        client.get("/eth/v1/beacon/deposit_snapshot")
    assert e.value.status == 404  # no eth1 service in this rig


def test_r4_lighthouse_extension_routes(served):
    """The lighthouse/* operator surface: health, validator counts, proto
    array dump, database info, inclusion, liveness, analysis routes."""
    harness, server, client = served
    chain = harness.chain

    health = client.get("/lighthouse/health")["data"]
    assert health["pid"] > 0

    ui = client.get("/lighthouse/ui/health")["data"]
    assert "network_name" in ui

    counts = client.get("/lighthouse/ui/validator_count")["data"]
    assert counts["active_ongoing"] == 16

    assert client.get("/lighthouse/syncing")["data"] == "Synced"
    assert client.get("/lighthouse/nat")["data"] is True
    assert client.get("/lighthouse/staking")["data"] is True
    assert "config" in client.get("/lighthouse/merge_readiness")["data"]

    pa = client.get("/lighthouse/proto_array")["data"]
    assert len(pa["nodes"]) >= 4
    head_nodes = [n for n in pa["nodes"]
                  if n["root"] == "0x" + chain.head_root.hex()]
    assert len(head_nodes) == 1

    info = client.get("/lighthouse/database/info")["data"]
    assert "schema_version" in info

    epoch = chain.current_slot() // harness.spec.slots_per_epoch
    g = client.get(f"/lighthouse/validator_inclusion/{epoch}/global")["data"]
    assert int(g["current_epoch_active_gwei"]) > 0
    one = client.get(f"/lighthouse/validator_inclusion/{epoch}/0")["data"]
    assert "is_slashed" in one

    live = client.post("/lighthouse/liveness",
                       {"epoch": str(epoch), "indices": ["0", "1"]})["data"]
    assert len(live) == 2

    rewards = client.get(
        "/lighthouse/analysis/block_rewards?start_slot=1&end_slot=4")["data"]
    assert len(rewards) >= 1

    perf = client.get("/lighthouse/analysis/attestation_performance/0")["data"]
    assert perf[0]["index"] == "0"

    packing = client.get("/lighthouse/analysis/block_packing_efficiency")["data"]
    assert len(packing) >= 1

    vi = client.post("/lighthouse/ui/validator_info",
                     {"indices": ["2"]})["data"]["validators"]
    assert "2" in vi and "balance" in vi["2"]["info"]


def test_r5_version_variant_routes(served):
    """v1 block fetch, v1 debug state, v2 debug heads, v2 pool dumps,
    validator metrics."""
    harness, server, client = served
    chain = harness.chain

    head = chain.head_root.hex()
    v1 = client.get(f"/eth/v1/beacon/blocks/0x{head}")
    assert "version" not in v1 and "data" in v1
    v2 = client.get(f"/eth/v2/beacon/blocks/0x{head}")
    assert v1["data"]["message"]["slot"] == v2["data"]["message"]["slot"]

    s1 = client.get("/eth/v1/debug/beacon/states/head")
    assert "version" not in s1 and "slot" in s1["data"]
    s2 = client.get("/eth/v2/debug/beacon/states/head")
    assert "version" in s2

    h1 = client.get("/eth/v1/debug/beacon/heads")["data"]
    assert h1 and "execution_optimistic" not in h1[0]
    h2 = client.get("/eth/v2/debug/beacon/heads")["data"]
    assert h2 and h2[0]["execution_optimistic"] is False

    pa = client.get("/eth/v2/beacon/pool/attestations")
    assert "version" in pa and isinstance(pa["data"], list)
    ps = client.get("/eth/v2/beacon/pool/attester_slashings")
    assert "version" in ps and isinstance(ps["data"], list)

    client.post("/lighthouse/ui/validator_monitor", ["0", "1"])
    m = client.post("/lighthouse/ui/validator_metrics",
                    {"indices": ["0", "5"]})["data"]["validators"]
    assert set(m) <= {"0"} or set(m) <= {"0", "1"}
    if "0" in m:
        assert "attestation_hits" in m["0"]
        assert "attestation_hit_percentage" in m["0"]


def test_r5_validator_inclusion_previous_epoch():
    """Previous-epoch inclusion requests replay the ancestor state, at epoch
    >= 1 where head-state shortcuts cannot answer; the field set is the
    reference's GlobalValidatorInclusionData."""
    set_backend("fake")
    try:
        harness = BeaconChainHarness(validator_count=16, fake_crypto=True)
        spe = harness.spec.slots_per_epoch
        harness.extend_chain(spe + 2)  # into epoch 1
        server = HttpApiServer(harness.chain).start()
        try:
            client = BeaconNodeHttpClient(server.url)
            epoch = harness.chain.current_slot() // spe
            assert epoch >= 1
            g = client.get(
                f"/lighthouse/validator_inclusion/{epoch - 1}/global")["data"]
            assert set(g) == {
                "current_epoch_active_gwei",
                "current_epoch_target_attesting_gwei",
                "previous_epoch_target_attesting_gwei",
                "previous_epoch_head_attesting_gwei",
            }
            assert int(g["current_epoch_active_gwei"]) > 0
            one = client.get(
                f"/lighthouse/validator_inclusion/{epoch - 1}/0")["data"]
            assert isinstance(one["is_previous_epoch_target_attester"], bool)
        finally:
            server.stop()
    finally:
        set_backend("host")


def test_payload_attributes_sse_topic():
    """Block production emits the payload_attributes SSE event."""
    from lighthouse_tpu_torch.chain import events as ev

    set_backend("fake")
    chain = sub = None
    try:
        harness = BeaconChainHarness(validator_count=8, fake_crypto=True)
        chain = harness.chain
        sub = chain.events.subscribe([ev.TOPIC_PAYLOAD_ATTRIBUTES])
        slot = harness.advance_slot()
        chain.process_block(harness.produce_signed_block(slot=slot))
        got = sub.poll(timeout=5)
        assert got is not None and got[0] == ev.TOPIC_PAYLOAD_ATTRIBUTES
        data = got[1]["data"]
        assert data["proposal_slot"] == str(slot)
        assert "proposer_index" in data and "parent_block_hash" in data
        assert "timestamp" in data["payload_attributes"]
    finally:
        if chain is not None and sub is not None:
            chain.events.unsubscribe(sub)
        set_backend("host")


def test_contribution_and_proof_sse_topic():
    """Verified sync contributions stream on the contribution_and_proof
    SSE topic."""
    from lighthouse_tpu_torch.chain import events as ev
    from lighthouse_tpu_torch.crypto.bls import api as bls

    set_backend("fake")
    chain = sub = None
    try:
        harness = BeaconChainHarness(validator_count=16, fake_crypto=True)
        chain = harness.chain
        sub = chain.events.subscribe([ev.TOPIC_CONTRIBUTION_AND_PROOF])
        slot = harness.advance_slot()
        contribution = chain.types.SyncCommitteeContribution(
            slot=slot, beacon_block_root=chain.head_root,
            subcommittee_index=0,
            aggregation_bits=[True] * (
                chain.spec.preset.sync_committee_size
                // chain.spec.sync_committee_subnet_count),
            signature=harness._canned_sig,
        )
        # bypass the spec preverify (selection-proof aggregator election is
        # data-dependent); the SSE wiring under test runs at pool insert.
        sig_set = bls.SignatureSet.multiple_pubkeys(
            bls.Signature.from_bytes(harness._canned_sig),
            [bls.PublicKey.from_bytes(
                bytes(chain.head_state.validators[0].pubkey))],
            b"msg")
        chain._preverify_signed_contribution = (
            lambda s: (contribution, [sig_set]))
        errs = chain.process_signed_contributions([object()])
        assert errs == [None], errs
        got = sub.poll(timeout=5)
        assert got is not None and got[0] == ev.TOPIC_CONTRIBUTION_AND_PROOF
        assert got[1]["slot"] == str(slot)
    finally:
        if chain is not None and sub is not None:
            chain.events.unsubscribe(sub)
        set_backend("host")


# ------------------------------------------ blinded blocks and light client


@pytest.fixture()
def rig_fake():
    """A fake-crypto chain with a mock relay over real HTTP as its builder."""
    set_backend("fake")
    harness = BeaconChainHarness(validator_count=16, fake_crypto=True)
    relay = MockRelay(harness.chain).start()
    harness.chain.builder = BuilderHttpClient(relay.url)
    yield harness, relay
    relay.stop()
    harness.chain.builder = None
    set_backend("host")


def _validator_client(harness, server):
    """The port's validator client, all 16 keys, on the port's typed
    client."""
    from lighthouse_tpu_torch.consensus.genesis import interop_secret_key
    from lighthouse_tpu_torch.validator_client import ValidatorClient

    return ValidatorClient(
        keys=[interop_secret_key(i) for i in range(16)],
        beacon_nodes=[BeaconNodeHttpClient(server.url)],
        spec=harness.spec,
        types=harness.types,
        genesis_validators_root=harness.chain.genesis_validators_root,
        fake_signatures=True,
    )


def _jax_validator_client(harness, server):
    """The JAX package's validator client on the JAX package's typed
    client, pointed at the port's server: its own types decode what the
    port serves."""
    from lighthouse_tpu.consensus.genesis import interop_secret_key
    from lighthouse_tpu.types.containers import build_types
    from lighthouse_tpu.validator_client import ValidatorClient

    j_spec, _ = specs({})
    return ValidatorClient(
        keys=[interop_secret_key(i) for i in range(16)],
        beacon_nodes=[JClient(server.url)],
        spec=j_spec,
        types=build_types(j_spec.preset),
        genesis_validators_root=harness.chain.genesis_validators_root,
        fake_signatures=True,
    )


def test_jax_and_port_clients_send_equal_requests(monkeypatch):
    """Two equal fake-crypto chains, each with a bidding relay and served
    by the port's server: the JAX package's client drives one slot of one,
    the port's the same slot of the other, through the builder path.  Every
    request (method, path, body) is the same, in order, and both heads are
    the same block."""
    recorded = {}
    urlopen = urllib.request.urlopen

    def recording(req, *a, **kw):
        url = req.full_url if isinstance(req, urllib.request.Request) else req
        port = int(url.split("/")[2].rsplit(":", 1)[1])
        if port in recorded:
            body = req.data if isinstance(req, urllib.request.Request) else None
            method = req.get_method() if isinstance(req, urllib.request.Request) else "GET"
            recorded[port].append((method, "/" + url.split("/", 3)[3],
                                   json.loads(body) if body else None))
        return urlopen(req, *a, **kw)

    monkeypatch.setattr(urllib.request, "urlopen", recording)
    heads, relays, servers = [], [], []
    try:
        for make in (_jax_validator_client, _validator_client):
            set_backend("fake")
            harness = BeaconChainHarness(validator_count=16, fake_crypto=True)
            relay = MockRelay(harness.chain).start()
            relays.append(relay)
            harness.chain.builder = BuilderHttpClient(relay.url)
            server = HttpApiServer(harness.chain).start()
            servers.append(server)
            recorded[server.port] = []
            vc = make(harness, server)
            vc.blocks.builder_proposals = True
            jbackends.set_backend("fake")
            summary = vc.run_slot(harness.advance_slot())
            assert summary["proposed"] is not None
            heads.append(harness.chain.head_root)
        jax_requests, port_requests = (recorded[s.port] for s in servers)
        assert port_requests == jax_requests
        assert any("blinded_blocks" in path for _, path, _ in port_requests)
        assert heads[0] == heads[1]
    finally:
        for server in servers:
            server.stop()
        for relay in relays:
            relay.stop()
        set_backend("host")


def test_http_v3_prefers_builder_and_vc_round_trip(rig_fake):
    """End to end over HTTP: the v3 route serves a blinded block when a
    relay bids; the validator client signs and publishes it; the head
    advances to the full (unblinded) block."""
    harness, relay = rig_fake
    chain = harness.chain
    server = HttpApiServer(chain).start()
    try:
        vc = _validator_client(harness, server)
        vc.blocks.builder_proposals = True
        slot = harness.advance_slot()
        summary = vc.run_slot(slot)
        assert summary["proposed"] is not None
        head = chain.get_block(chain.head_root)
        assert int(head.message.slot) == slot
        assert hasattr(head.message.body, "execution_payload")
    finally:
        server.stop()


def test_builder_failure_falls_back_to_local(rig_fake):
    harness, relay = rig_fake
    chain = harness.chain
    relay.stop()  # relay is down: builder path must fail gracefully
    server = HttpApiServer(chain).start()
    try:
        vc = _validator_client(harness, server)
        vc.blocks.builder_proposals = True
        slot = harness.advance_slot()
        summary = vc.run_slot(slot)
        assert summary["proposed"] is not None, "local fallback did not engage"
        assert int(chain.get_block(chain.head_root).message.slot) == slot
    finally:
        server.stop()


def test_registrations_forwarded_to_relay():
    """Real crypto (the host backend): a signed validator registration
    POSTed to the port's server reaches the relay."""
    from lighthouse_tpu_torch.consensus.genesis import interop_secret_key
    from lighthouse_tpu_torch.execution_layer.builder_client import builder_signing_root

    set_backend("host")
    harness = BeaconChainHarness(validator_count=16, fake_crypto=False)
    relay = MockRelay(harness.chain).start()
    harness.chain.builder = BuilderHttpClient(relay.url)
    server = HttpApiServer(harness.chain).start()
    try:
        client = BeaconNodeHttpClient(server.url)
        sk = interop_secret_key(0)
        pk = sk.public_key().to_bytes()
        reg = harness.types.ValidatorRegistrationV1(
            fee_recipient=b"\x11" * 20, gas_limit=30_000_000,
            timestamp=1_600_000_000, pubkey=pk,
        )
        sig = sk.sign(builder_signing_root(reg.hash_tree_root(), harness.spec))
        signed = harness.types.SignedValidatorRegistrationV1(
            message=reg, signature=sig.to_bytes()
        )
        client.register_validator([signed])
        assert pk in relay.registrations
    finally:
        server.stop()
        relay.stop()


def test_lc_http_routes():
    """Light-client bootstrap and updates over HTTP, on short sync
    periods."""
    import dataclasses

    from lighthouse_tpu_torch.types.spec import MINIMAL_PRESET, minimal_spec

    set_backend("fake")
    try:
        preset = dataclasses.replace(MINIMAL_PRESET, epochs_per_sync_committee_period=2)
        spec = minimal_spec(preset=preset, altair_fork_epoch=0, bellatrix_fork_epoch=0,
                            capella_fork_epoch=0, deneb_fork_epoch=None)
        harness = BeaconChainHarness(validator_count=16, spec=spec, fake_crypto=True)
        chain = harness.chain
        spe = harness.spec.slots_per_epoch
        harness.extend_chain(spe * 5)
        server = HttpApiServer(chain).start()
        try:
            client = BeaconNodeHttpClient(server.url)
            _, f_root = chain.finalized_checkpoint()
            bootstrap = client.light_client_bootstrap(f_root, types=harness.types)
            assert bootstrap.header.beacon.hash_tree_root() == f_root
            fin = client.light_client_finality_update(types=harness.types)
            assert any(fin.sync_aggregate.sync_committee_bits)
            opt = client.light_client_optimistic_update(types=harness.types)
            assert any(opt.sync_aggregate.sync_committee_bits)
            period = (int(fin.finalized_header.beacon.slot) // spe) \
                // harness.spec.preset.epochs_per_sync_committee_period
            ups = client.light_client_updates(0, period + 2, types=harness.types)
            assert ups
        finally:
            server.stop()
    finally:
        set_backend("host")


# ------------------------------------------------------------ the route table


def test_route_table_is_the_jax_packages_without_autotune():
    """The whole JAX table, ``GET /lighthouse/autotune`` included (the
    name is from before the route was ported)."""
    def table(mod):
        return [(m, p, prio, fn.__name__) for m, p, prio, fn in mod.ROUTES]

    jax_table = table(jserver)
    assert ("GET", "/lighthouse/autotune", "api_request_p1", "lighthouse_autotune") in jax_table
    assert table(pserver) == jax_table
    assert len(pserver.ROUTES) == 122
    assert pserver.CACHED_ROUTES == jserver.CACHED_ROUTES
    assert pserver.match_route("GET", "/lighthouse/autotune") is not None


def test_autotune_route_answers_404(served):
    """``GET /lighthouse/autotune`` answers 200 with the JAX body's keys
    (the name is from before the route was ported): the controller's
    snapshot beside the admission state, plus the port's measured walk
    lookahead; the JAX package's Fq-lowering choice is always None."""
    from lighthouse_tpu import autotune as jautotune

    _, server, client = served
    data = client.get("/lighthouse/autotune")["data"]
    jax_keys = set(jautotune.snapshot()) | {"admission"}
    assert set(data) == jax_keys | {"walk_lookahead"}
    assert data["fq_backend"] is None
    assert data["mode"] in ("0", "pinned", "live")
    assert set(data["admission"]["effective"]) == set(data["admission"]["bounds"])


# -------------------------------------------------------------------- interop


@pytest.fixture(scope="module")
def parity_chains():
    """One harness schedule (capella from genesis, the minimal preset) in
    both packages, extended to finality, each chain served by its own
    package's server."""
    jhs, phs = harnesses({}, validators=16)
    jbackends.set_backend("fake")  # both servers verify with fake crypto
    jhs.extend_chain(5 * jhs.spec.slots_per_epoch + 2)
    set_backend("fake")
    phs.extend_chain(5 * phs.spec.slots_per_epoch + 2)
    assert jhs.chain.head_root == phs.chain.head_root
    jsrv = JServer(jhs.chain).start()
    psrv = HttpApiServer(phs.chain).start()
    yield jhs, phs, jsrv, psrv
    jsrv.stop()
    psrv.stop()


def test_port_client_reads_jax_server(parity_chains):
    jhs, phs, jsrv, _ = parity_chains
    client = BeaconNodeHttpClient(jsrv.url)
    assert client.node_version().startswith("lighthouse-tpu/")
    assert client.state_root("head") == phs.chain.head_state.hash_tree_root()
    assert client.block_root("head") == phs.chain.head_root
    fc = client.finality_checkpoints("head")
    assert fc["finalized"]["root"] == "0x" + phs.chain.finalized_checkpoint()[1].hex()
    epoch = phs.chain.current_slot() // phs.spec.slots_per_epoch
    assert len(client.attester_duties(epoch, list(range(16)))["data"]) == 16
    data = client.attestation_data(phs.chain.current_slot(), 0, types=phs.types)
    assert data == phs.chain.produce_attestation_data(phs.chain.current_slot(), 0)


def test_jax_client_reads_port_server(parity_chains):
    jhs, phs, _, psrv = parity_chains
    client = JClient(psrv.url)
    assert client.node_version() == pserver.VERSION_STRING
    assert client.state_root("head") == jhs.chain.head_state.hash_tree_root()
    assert client.block_root("head") == jhs.chain.head_root
    assert client.validators("head", ids=["3"])[0]["index"] == "3"
    data = client.attestation_data(jhs.chain.current_slot(), 0, types=jhs.types)
    assert data == jhs.chain.produce_attestation_data(jhs.chain.current_slot(), 0)


# --------------------------------------------------------------------- parity

#: Fields whose values name the implementation, not the chain: the version
#: string (``lighthouse-tpu/0.1.0`` in the port, ``0.2.0`` in the JAX
#: package), the peer id and the ENR.
EXEMPT = {
    "/eth/v1/node/version": ("data", "version"),
    "/eth/v1/node/identity": ("data", "peer_id", "enr"),
}
#: Routes that report on the process (its host, its rings and counters, its
#: cache and admission state) rather than on the chain: compared by keys.
#: The port's device summary has the JAX package's sections, ``autotune``
#: and ``mesh`` among them, and its fault registry names the points the
#: port has.
PROCESS_ROUTES = {
    "/lighthouse/health", "/lighthouse/ui/health", "/lighthouse/traces",
    "/lighthouse/device", "/lighthouse/device/batches", "/lighthouse/faults",
    "/lighthouse/serving", "/lighthouse/postmortems",
    "/lighthouse/postmortems/journal", "/lighthouse/events/subscribers",
}
HTTP_FAMILIES = ("http_api_requests_total", "http_api_request_seconds",
                 "http_response_cache_hits_total", "http_response_cache_misses_total",
                 "http_response_cache_entries", "device_arbiter_grants_total")


def raw_request(port: int, method: str, path: str, body=None, ssz: bool = False,
                ssz_body: bytes = None, headers=None):
    """-> (status, content type, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    hdrs = dict(headers or {})
    payload = None
    if ssz_body is not None:
        payload = ssz_body
        hdrs["Content-Type"] = "application/octet-stream"
    elif body is not None:
        payload = json.dumps(body)
        hdrs["Content-Type"] = "application/json"
    if ssz:
        hdrs["Accept"] = "application/octet-stream"
    try:
        conn.request(method, path, body=payload, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type", ""), resp.read()
    finally:
        conn.close()


def parity_requests(phs) -> list:
    """(method, path, JSON body, Accept SSZ) for every route the JAX
    package's tests call, on the parity chain's values."""
    chain, spec = phs.chain, phs.spec
    spe = spec.slots_per_epoch
    slot = chain.current_slot()
    epoch = slot // spe
    head = "0x" + chain.head_root.hex()
    _, f_root = chain.finalized_checkpoint()
    pk3 = "0x" + bytes(chain.head_state.validators[3].pubkey).hex()
    ids = [str(i) for i in range(16)]
    get = [
        "/eth/v1/node/version", "/eth/v1/node/identity", "/eth/v1/node/syncing",
        "/eth/v1/node/health", "/eth/v1/node/peers", "/eth/v1/node/peer_count",
        "/eth/v1/node/peers/nope",
        "/eth/v1/beacon/genesis",
        "/eth/v1/beacon/states/head/root", "/eth/v1/beacon/states/head/fork",
        "/eth/v1/beacon/states/head/finality_checkpoints",
        "/eth/v1/beacon/states/finalized/finality_checkpoints",
        "/eth/v1/beacon/states/head/validators",
        f"/eth/v1/beacon/states/head/validators?id=3,{pk3}&status=active_ongoing",
        "/eth/v1/beacon/states/head/validators/3",
        f"/eth/v1/beacon/states/head/validators/{pk3}",
        "/eth/v1/beacon/states/head/validator_balances?id=0,1,2",
        f"/eth/v1/beacon/states/head/committees?epoch={epoch}",
        f"/eth/v1/beacon/states/head/committees?slot={slot}&index=0",
        "/eth/v1/beacon/states/head/sync_committees", "/eth/v1/beacon/states/head/randao",
        "/eth/v1/beacon/states/2/root", f"/eth/v1/beacon/states/{slot + 1}/root",
        "/eth/v1/beacon/headers", f"/eth/v1/beacon/headers?slot={slot - 1}",
        "/eth/v1/beacon/headers/head", "/eth/v1/beacon/headers/genesis",
        f"/eth/v1/beacon/headers/{head}", "/eth/v1/beacon/headers/3",
        "/eth/v2/beacon/blocks/head", "/eth/v1/beacon/blocks/head",
        f"/eth/v2/beacon/blocks/0x{'ab' * 32}",
        "/eth/v1/beacon/blocks/head/root", "/eth/v1/beacon/blocks/finalized/root",
        "/eth/v1/beacon/blocks/head/attestations",
        "/eth/v1/beacon/blob_sidecars/head",
        "/eth/v1/beacon/blinded_blocks/head",
        f"/eth/v1/beacon/light_client/bootstrap/0x{f_root.hex()}",
        "/eth/v1/beacon/light_client/updates?start_period=0&count=1",
        "/eth/v1/beacon/light_client/finality_update",
        "/eth/v1/beacon/light_client/optimistic_update",
        "/eth/v1/beacon/pool/attestations", f"/eth/v1/beacon/pool/attestations?slot={slot}",
        "/eth/v2/beacon/pool/attestations", "/eth/v1/beacon/pool/voluntary_exits",
        "/eth/v1/beacon/pool/proposer_slashings", "/eth/v1/beacon/pool/attester_slashings",
        "/eth/v2/beacon/pool/attester_slashings",
        "/eth/v1/beacon/pool/bls_to_execution_changes",
        "/eth/v1/beacon/deposit_snapshot",
        "/eth/v1/builder/states/head/expected_withdrawals",
        f"/eth/v1/validator/duties/proposer/{epoch}",
        f"/eth/v1/validator/attestation_data?slot={slot}&committee_index=0",
        f"/eth/v1/validator/sync_committee_contribution?slot={slot}&subcommittee_index=0"
        f"&beacon_block_root={head}",
        "/eth/v1/config/spec", "/eth/v1/config/fork_schedule",
        "/eth/v1/config/deposit_contract",
        "/eth/v2/debug/beacon/states/head", "/eth/v1/debug/beacon/states/head",
        "/eth/v1/debug/beacon/heads", "/eth/v2/debug/beacon/heads",
        "/eth/v1/debug/fork_choice",
        "/eth/v1/beacon/rewards/blocks/head",
        "/lighthouse/ui/validator_count", "/lighthouse/syncing", "/lighthouse/peers",
        "/lighthouse/peers/connected", "/lighthouse/proto_array",
        "/lighthouse/database/info", "/lighthouse/eth1/syncing",
        "/lighthouse/eth1/block_cache", "/lighthouse/eth1/deposit_cache",
        "/lighthouse/nat", "/lighthouse/staking", "/lighthouse/merge_readiness",
        f"/lighthouse/validator_inclusion/{epoch}/global",
        f"/lighthouse/validator_inclusion/{epoch - 1}/global",
        f"/lighthouse/validator_inclusion/{epoch}/0",
        f"/lighthouse/validator_inclusion/{epoch - 1}/5",
        f"/lighthouse/analysis/block_rewards?start_slot=1&end_slot={slot}",
        "/lighthouse/analysis/attestation_performance/0",
        "/lighthouse/analysis/block_packing_efficiency",
        f"/lighthouse/ui/validator_monitor/{epoch - 1}",
        "/lighthouse/fleet", "/lighthouse/fleet?limit=junk",
        "/lighthouse/traces/nope",
        "/lighthouse/autotune_is_not_a_route",
    ]
    reqs = [("GET", p, None, False) for p in get]
    reqs += [("GET", p, None, True) for p in (
        "/eth/v2/beacon/blocks/head", "/eth/v2/beacon/blocks/3",
        "/eth/v2/debug/beacon/states/head", "/eth/v2/debug/beacon/states/finalized",
        "/eth/v1/beacon/blinded_blocks/head")]
    reqs += [
        ("POST", "/eth/v1/beacon/states/head/validators", {"ids": ["0", pk3]}, False),
        ("POST", "/eth/v1/beacon/states/head/validator_balances", {"ids": ["0", "3"]}, False),
        ("POST", f"/eth/v1/validator/duties/attester/{epoch}", ids, False),
        ("POST", f"/eth/v1/validator/duties/attester/{epoch + 1}", ids[:4], False),
        ("POST", f"/eth/v1/validator/duties/sync/{epoch}", ids, False),
        ("POST", f"/eth/v1/validator/liveness/{epoch}", ["0", "1"], False),
        ("POST", "/lighthouse/liveness", {"epoch": str(epoch), "indices": ["0", "1"]}, False),
        ("POST", f"/eth/v1/beacon/rewards/attestations/{epoch - 1}", ["0", "3"], False),
        ("POST", f"/eth/v1/beacon/rewards/attestations/{epoch - 2}", None, False),
        ("POST", "/eth/v1/beacon/rewards/sync_committee/head", None, False),
        ("POST", "/lighthouse/analysis/block_rewards",
         {"start_slot": "1", "end_slot": str(slot)}, False),
        ("POST", "/lighthouse/ui/validator_info", {"indices": ["2"]}, False),
        ("POST", "/lighthouse/ui/validator_monitor", ["0", "1"], False),
        ("POST", "/lighthouse/ui/validator_metrics", {"indices": ["0", "5"]}, False),
        ("POST", "/eth/v1/validator/prepare_beacon_proposer",
         [{"validator_index": "1", "fee_recipient": "0x" + "11" * 20}], False),
        ("POST", "/eth/v1/validator/beacon_committee_subscriptions",
         [{"validator_index": "1", "committee_index": "0", "committees_at_slot": "1",
           "slot": str(slot + 1), "is_aggregator": True}], False),
        ("POST", "/eth/v1/validator/sync_committee_subscriptions",
         [{"validator_index": "1", "sync_committee_indices": ["0"],
           "until_epoch": str(epoch + 1)}], False),
        ("POST", "/eth/v1/beacon/pool/voluntary_exits",
         {"message": {"epoch": str(epoch), "validator_index": "4"},
          "signature": "0xc0" + "00" * 95}, False),
        ("POST", "/lighthouse/database/reconstruct", None, False),
        ("POST", "/lighthouse/device/profile?seconds=zero", None, False),
        ("POST", "/lighthouse/faults", {"spec": "unknown.point=error"}, False),
        ("DELETE", "/lighthouse/faults?id=abc", None, False),
        ("GET", "/lighthouse/device/batches?limit=junk", None, False),
        ("GET", "/lighthouse/postmortems/journal?limit=bogus", None, False),
        ("GET", "/lighthouse/postmortems?bundle=../etc/passwd", None, False),
    ]
    reqs += [("GET", p, None, False) for p in sorted(PROCESS_ROUTES)]
    return reqs


def canonical(path: str, status: int, ctype: str, body: bytes):
    """What the parity check compares for one answer."""
    route = path.split("?")[0]
    if "json" not in ctype or not body:
        return status, ctype, body
    out = json.loads(body)
    if route in EXEMPT:
        keep = EXEMPT[route]
        for k in keep[1:]:
            out[keep[0]].pop(k)
    if route in PROCESS_ROUTES and status == 200:
        data = out["data"]
        if isinstance(data, dict):
            out = sorted(data)
        else:
            out = type(data).__name__
    return status, ctype, out


def exchange(jsrv, psrv, reqs) -> list:
    """Send each request to both servers; -> the mismatches."""
    bad = []
    for method, path, body, ssz in reqs:
        j = raw_request(jsrv.port, method, path, body, ssz)
        p = raw_request(psrv.port, method, path, body, ssz)
        if canonical(path, *j) != canonical(path, *p):
            bad.append((method, path, ssz, j[:2], p[:2], j[2][:300], p[2][:300]))
    return bad


def test_servers_answer_alike(parity_chains):
    jhs, phs, jsrv, psrv = parity_chains
    reqs = parity_requests(phs)
    assert exchange(jsrv, psrv, reqs) == []
    # a second pass answers from the response caches, equal again
    assert exchange(jsrv, psrv, reqs) == []
    routes = {(m, pserver.match_route(m, p.split("?")[0])[3])
              for m, p, _, _ in reqs if pserver.match_route(m, p.split("?")[0])}
    # every GET route the JAX package's tests call is in the list
    for route in ("/eth/v1/beacon/states/{state_id}/validators/{validator_id}",
                  "/eth/v1/beacon/light_client/bootstrap/{block_root}",
                  "/eth/v2/debug/beacon/states/{state_id}",
                  "/lighthouse/validator_inclusion/{epoch}/{validator_id}"):
        assert ("GET", route) in routes


def _metric_families(text: str) -> set:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def test_metrics_carry_the_http_families(parity_chains):
    jhs, phs, jsrv, psrv = parity_chains
    raw_request(jsrv.port, "GET", "/eth/v1/beacon/states/head/root")
    raw_request(psrv.port, "GET", "/eth/v1/beacon/states/head/root")
    fams = []
    for srv in (jsrv, psrv):
        status, ctype, body = raw_request(srv.port, "GET", "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        fams.append(_metric_families(body.decode()) & set(HTTP_FAMILIES))
    assert fams[0] == fams[1] == set(HTTP_FAMILIES)


def test_writes_answer_alike(parity_chains):
    """The same writes to both nodes, in order: an attestation to the pool,
    a refused attestation, a block produced by ``/eth/v3`` and published
    as JSON, the next as SSZ; every answer and the nodes' heads equal."""
    jhs, phs, jsrv, psrv = parity_chains
    slot = phs.chain.current_slot()
    status, _, body = raw_request(
        psrv.port, "GET", f"/eth/v1/validator/attestation_data?slot={slot}&committee_index=0")
    data = json.loads(body)["data"]
    committee = h.get_beacon_committee(phs.chain.head_state, slot, 0, phs.spec)
    bits = "0x" + bytes([1 | (1 << len(committee))]).hex()  # member 0, then the length bit
    att = {"aggregation_bits": bits, "data": data,
           "signature": "0x" + bytes(phs._canned_sig).hex()}
    unknown = dict(att, data=dict(data, beacon_block_root="0x" + "ee" * 32))
    data_root = container_from_json(phs.types.AttestationData, data).hash_tree_root().hex()
    reqs = [("POST", "/eth/v1/beacon/pool/attestations", [att], False),
            ("POST", "/eth/v1/beacon/pool/attestations", [unknown], False),
            ("GET", f"/eth/v1/beacon/pool/attestations?slot={slot}", None, False),
            ("GET", f"/eth/v1/validator/aggregate_attestation?slot={slot}"
             f"&attestation_data_root=0x{data_root}", None, False),
            ("GET", f"/eth/v2/validator/aggregate_attestation?slot={slot}"
             f"&attestation_data_root=0x{data_root}&committee_index=0", None, False)]
    assert exchange(jsrv, psrv, reqs) == []
    for publish_ssz in (False, True):
        jslot = jhs.advance_slot()
        pslot = phs.advance_slot()
        assert jslot == pslot
        state, _ = phs.chain.state_at_slot(pslot)
        proposer = h.get_beacon_proposer_index(state, phs.spec)
        reveal = "0x" + bytes(phs.randao_reveal(state, pslot, proposer)).hex()
        produced = []
        for srv in (jsrv, psrv):
            status, ctype, body = raw_request(
                srv.port, "GET", f"/eth/v3/validator/blocks/{pslot}?randao_reveal={reveal}"
                f"&graffiti=0x{'42' * 32}")
            assert status == 200, body[:300]
            produced.append(json.loads(body))
        assert produced[0] == produced[1]
        fork = produced[1]["version"]
        block = container_from_json(phs.types.block[fork], produced[1]["data"])
        signed = phs.types.signed_block[fork](message=block, signature=phs._canned_sig)
        if publish_ssz:
            answers = [raw_request(srv.port, "POST", "/eth/v2/beacon/blocks",
                                   ssz_body=signed.as_ssz_bytes(),
                                   headers={"Eth-Consensus-Version": fork})
                       for srv in (jsrv, psrv)]
        else:
            body = {"message": produced[1]["data"],
                    "signature": "0x" + bytes(phs._canned_sig).hex()}
            answers = [raw_request(srv.port, "POST", "/eth/v1/beacon/blocks", body)
                       for srv in (jsrv, psrv)]
        assert answers[0] == answers[1] and answers[1][0] == 200, answers
        assert jhs.chain.head_root == phs.chain.head_root == block.hash_tree_root()
    assert exchange(jsrv, psrv, parity_requests(phs)) == []


# --------------------------------------------------- chip_smoke.py's [http]


def test_chip_smoke_http_phase_on_cpu(monkeypatch):
    """``chip_smoke.phase_http``, the ``[http]`` phase, on the CPU: a
    4,096-validator block import case (no blobs) imported by a
    checkpoint-synced node, then every gate of the phase on the ``"torch"``
    backend's plain versions (stand-ins count their launches), the profile
    on the CPU alone."""
    import chip_smoke
    from lighthouse_tpu_torch import workload
    from lighthouse_tpu_torch.chain import BeaconChain, ManualSlotClock
    from lighthouse_tpu_torch.chain.mock_el import MockExecutionEngine
    from lighthouse_tpu_torch.ops import cuda_fq

    for name in ("fq_mul", "fq2_mul"):
        plain = getattr(cuda_fq, f"{name}_plain")

        def counted(a, b, name=name, plain=plain):
            cuda_fq.LAUNCHES[name] += 1
            return plain(a, b)

        monkeypatch.setattr(cuda_fq, f"{name}_plain", counted)
    monkeypatch.setenv("LIGHTHOUSE_TPU_FORCE_PROFILER", "1")
    set_backend("torch")
    served = None
    try:
        case = workload.block_import_case(4096, seed=0xB10C, blob_commitments=[])
        workload.warm_pubkey_cache(case.keys)
        signed, spec = case.signed_block, case.spec
        clock = ManualSlotClock(int(case.pre_state.genesis_time), spec.seconds_per_slot)
        clock.set_slot(int(signed.message.slot))
        chain = BeaconChain(genesis_state=case.pre_state, types=case.types, spec=spec,
                            slot_clock=clock, execution_engine=MockExecutionEngine())
        chain.process_block(signed)
        served = chip_smoke.api_server(chain)
        out = chip_smoke.phase_http("cpu", case, chain, [], case.host_state.as_ssz_bytes(),
                                    served, device="cpu")
    finally:
        if served is not None:
            served[0].stop()
            served[1].shutdown()
        set_backend("host")
    assert out["state_ssz"] == case.host_state.as_ssz_bytes()
    assert min(out["launches"].values()) > 0
    assert len(out["seconds"]) == 25 and out["post_s"] > 0
