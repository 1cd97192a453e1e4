"""The port's execution layer (``execution_layer/``) vs the JAX package's.

``lighthouse_tpu_torch.execution_layer`` copies the JAX package's JWT
auth, Engine API client and codecs, engine state machine,
``ExecutionLayer`` and ``MockEngineServer``.  Every comparison is exact
(bytes, JSON, verdicts, states, roots):

- JWT tokens byte-equal for the same secret and ``iat``, each package's
  token accepted by the other, the same refusals;
- ``payload_to_json`` / ``payload_from_json`` equal for each fork's
  harness payload, and the Prague request encoding;
- the four pairings of client and server (the port's client against the
  JAX package's ``MockEngineServer`` and the other way round, and each
  package alone): the same JSON-RPC calls reach the server and the same
  answers come back, through capability exchange, payload production,
  ``newPayload`` (VALID, INVALID, SYNCING), payload bodies by hash and
  range;
- the upcheck state machine: offline, online, auth failure, unreachable,
  cooldown and an injected ``engine.request`` fault, in both packages;
- the JAX package's ``test_execution_layer.py`` chain cases on the port's
  harness (imports over the socket, production, an invalid payload, an
  optimistic import, electra's V4 calls, an EL restart), each against the
  JAX chain's block roots and engine counters.
"""

import json

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu import execution_layer as jel  # noqa: E402
from lighthouse_tpu import fault_injection as jfi  # noqa: E402
from lighthouse_tpu.execution_layer import auth as jauth  # noqa: E402
from lighthouse_tpu.execution_layer import engine_api as japi  # noqa: E402
from lighthouse_tpu.execution_layer import engines as jengines  # noqa: E402
from lighthouse_tpu.execution_layer.mock_server import MockEngineServer as JServer  # noqa: E402
from lighthouse_tpu.types.containers import build_types as j_build_types  # noqa: E402
from lighthouse_tpu_torch import execution_layer as pel  # noqa: E402
from lighthouse_tpu_torch import fault_injection as pfi  # noqa: E402
from lighthouse_tpu_torch.chain.beacon_chain import BlockError  # noqa: E402
from lighthouse_tpu_torch.execution_layer import auth as pauth  # noqa: E402
from lighthouse_tpu_torch.execution_layer import engine_api as papi  # noqa: E402
from lighthouse_tpu_torch.execution_layer import engines as pengines  # noqa: E402
from lighthouse_tpu_torch.execution_layer.mock_server import MockEngineServer as PServer  # noqa: E402
from lighthouse_tpu_torch.types.containers import build_types  # noqa: E402
from test_torch_chain import harnesses, jax_backend, port_cpu, specs  # noqa: E402,F401

SECRET = bytes(range(32))
SERVERS = {"jax": JServer, "port": PServer}
CLIENTS = {"jax": jel.ExecutionLayer, "port": pel.ExecutionLayer}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Recorded:
    """A mock engine server of either package whose JSON-RPC calls are
    kept, as (method, params) with the params as their JSON text."""

    def __init__(self, pkg: str, **kw):
        self.server = SERVERS[pkg](SECRET, **kw)
        self.calls = []
        answer = self.server.handle

        def handle(method, params):
            self.calls.append((method, json.dumps(params, sort_keys=True)))
            return answer(method, params)

        self.server.handle = handle
        self.server.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.server.stop()
        return False


# ------------------------------------------------------------------ JWT


@pytest.mark.parametrize("iat", [0, 1_600_000_000, 1_700_000_123, 2 ** 33])
@pytest.mark.parametrize("secret", [SECRET, b"\xff" * 32, bytes(32)])
def test_jwt_tokens_equal(secret, iat):
    token = pauth.generate_token(secret, iat=iat)
    assert token == jauth.generate_token(secret, iat=iat)
    pauth.validate_token(jauth.generate_token(secret, iat=iat), secret, now=iat + 60)
    jauth.validate_token(token, secret, now=iat - 60)


@pytest.mark.parametrize("case", ["wrong_secret", "stale", "malformed", "bad_base64", "claims"])
def test_jwt_refusals_equal(case):
    def run(auth):
        token = auth.generate_token(SECRET, iat=1_000_000)
        now = 1_000_000
        if case == "wrong_secret":
            args = (token, b"\x01" * 32, now)
        elif case == "stale":
            args = (token, SECRET, now + 61)
        elif case == "malformed":
            args = ("not.a.jwt.at.all", SECRET, now)
        elif case == "bad_base64":
            head, claims, _ = token.split(".")
            args = (f"{head}.{claims}.%%%", SECRET, now)
        else:
            import base64
            import hmac
            from hashlib import sha256

            head = token.split(".")[0]
            claims = base64.urlsafe_b64encode(b"[1, 2]").rstrip(b"=").decode()
            sig = hmac.new(SECRET, f"{head}.{claims}".encode(), sha256).digest()
            args = (f"{head}.{claims}." + base64.urlsafe_b64encode(sig).rstrip(b"=").decode(),
                    SECRET, now)
        with pytest.raises(auth.JwtError) as err:
            auth.validate_token(*args)
        return str(err.value)

    assert run(pauth) == run(jauth)


def test_strip_prefix_equal():
    hexed = "0x" + SECRET.hex()
    assert pauth.strip_prefix(hexed) == jauth.strip_prefix(hexed) == SECRET
    for auth in (pauth, jauth):
        with pytest.raises(auth.JwtError, match="32 bytes"):
            auth.strip_prefix("0xabcd")


# ----------------------------------------------------------------- codecs


FORKS = {
    "bellatrix": dict(capella_fork_epoch=None),
    "capella": {},
    "deneb": dict(deneb_fork_epoch=0),
    "electra": dict(deneb_fork_epoch=0, electra_fork_epoch=0),
}


@pytest.mark.parametrize("fork", sorted(FORKS))
def test_payload_json_equal(fork):
    """A harness block's payload (with its withdrawals, where the fork has
    them) through both packages' codecs."""
    jhs, phs = harnesses(FORKS[fork], validators=16)
    with jax_backend("fake"):
        (root,) = phs.extend_chain(1)
        assert jhs.extend_chain(1) == [root]
    payload = phs.chain.get_block(root).message.body.execution_payload
    j_payload = jhs.chain.get_block(root).message.body.execution_payload
    assert type(phs.head_state).fork_name == fork
    p_json = papi.payload_to_json(payload)
    assert p_json == japi.payload_to_json(j_payload)
    back = papi.payload_from_json(p_json, phs.types, fork)
    assert back.as_ssz_bytes() == payload.as_ssz_bytes()
    assert back.as_ssz_bytes() == japi.payload_from_json(p_json, jhs.types, fork).as_ssz_bytes()


def test_execution_requests_encoding_equal():
    """Prague's ``executionRequests`` (type byte || SSZ list) in both
    packages, and the JAX package's round-trip case."""
    def requests(types):
        return types.ExecutionRequests(
            deposits=[types.DepositRequest(
                pubkey=b"\xaa" * 48, withdrawal_credentials=b"\x01" * 32,
                amount=32 * 10 ** 9, signature=b"\xbb" * 96, index=7)],
            withdrawals=[types.WithdrawalRequest(
                source_address=b"\xcc" * 20, validator_pubkey=b"\xdd" * 48, amount=0)],
            consolidations=[])

    j_spec, p_spec = specs({})
    jtypes, ptypes = j_build_types(j_spec.preset), build_types(p_spec.preset)
    encoded = papi.execution_requests_to_json(requests(ptypes))
    assert encoded == japi.execution_requests_to_json(requests(jtypes))
    assert len(encoded) == 2 and encoded[0].startswith("0x00") and encoded[1].startswith("0x01")
    back = papi.execution_requests_from_json(encoded, ptypes)
    assert back.hash_tree_root() == requests(ptypes).hash_tree_root()
    assert back.as_ssz_bytes() == japi.execution_requests_from_json(encoded, jtypes).as_ssz_bytes()
    for api in (papi, japi):
        with pytest.raises(api.EngineApiError, match="unknown execution request type"):
            api.execution_requests_from_json(["0x07aa"], ptypes if api is papi else jtypes)


@pytest.mark.parametrize("seed", range(4))
def test_versioned_hash_equal(seed):
    import random

    commitment = random.Random(seed).randbytes(48)
    got = papi.kzg_commitment_to_versioned_hash(commitment)
    assert got == japi.kzg_commitment_to_versioned_hash(commitment)
    assert got[0] == 1 and len(got) == 32


# ------------------------------------------------- clients against servers


def engine_transcript(client_pkg: str, server_pkg: str) -> list:
    """One client/server pairing through the Engine API; the calls the
    server saw and every answer, as comparable values."""
    jhs, phs = harnesses(dict(deneb_fork_epoch=0), validators=16)
    with jax_backend("fake"):
        phs.extend_chain(1)
        jhs.extend_chain(1)
    hs = phs if client_pkg == "port" else jhs
    out = []
    with Recorded(server_pkg) as rec:
        el = CLIENTS[client_pkg](url=rec.server.url, jwt_secret=SECRET)
        out.append(("state", el.engine.state, el.is_online(), el.engine.state))
        out.append(("caps", list(el.engine.capabilities)))
        state = hs.chain.head_state.copy()
        payload = el.produce_payload(state, hs.types, hs.spec)
        out.append(("payload", payload.as_ssz_bytes()))
        block_hash = bytes(payload.block_hash)
        hashes = [b"\x01" + bytes(31), b"\x01" + b"\x02" * 31]
        out.append(("valid", el.notify_new_payload(payload, versioned_hashes=hashes,
                                                   parent_beacon_block_root=b"\x05" * 32)))
        rec.server.syncing_hashes.add(block_hash)
        out.append(("syncing", el.notify_new_payload(payload),
                    block_hash in el.optimistic_hashes))
        rec.server.syncing_hashes.discard(block_hash)
        rec.server.invalid_hashes.add(block_hash)
        out.append(("invalid", el.notify_new_payload(payload)))
        out.append(("bodies", el.get_payload_bodies_by_hash([block_hash, b"\x00" * 32]),
                    el.get_payload_bodies_by_range(int(payload.block_number), 2)))
        out.append(("fcu", el.notify_forkchoice_updated(
            head_block_hash=block_hash, finalized_block_hash=b"\x00" * 32, fork="deneb")))
        out.append(("counts", rec.server.payloads_seen, rec.server.fcu_seen))
        out.append(("calls", rec.calls))
    return out


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_engine_pairings_match_jax(client_pkg, server_pkg):
    expected = engine_transcript("jax", "jax")
    got = engine_transcript(client_pkg, server_pkg)
    assert got == expected
    assert got[0] == ("state", "offline", True, "online")
    assert dict((k[0], k[1:]) for k in got)["valid"] == (True,)


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"), ("jax", "port")])
def test_client_version_crosses(client_pkg, server_pkg):
    with Recorded(server_pkg) as rec:
        el = CLIENTS[client_pkg](url=rec.server.url, jwt_secret=SECRET)
        assert el.get_client_version() == {"code": "MK", "name": "mock-engine",
                                           "version": "0.1.0", "commit": "deadbeef"}
        (_, params), = [c for c in rec.calls if c[0] == "engine_getClientVersionV1"]
        assert json.loads(params)[0]["name"] == "lighthouse-tpu"


# ------------------------------------------------------- the state machine


def machine_run(pkg: str) -> list:
    el_mod = {"jax": jel, "port": pel}[pkg]
    engines = {"jax": jengines, "port": pengines}[pkg]
    fi = {"jax": jfi, "port": pfi}[pkg]
    out = []
    with Recorded(pkg) as rec:
        el = el_mod.ExecutionLayer(url=rec.server.url, jwt_secret=SECRET)
        out.append((el.engine.state, el.is_online(), el.engine.state))
        bad = el_mod.ExecutionLayer(url=rec.server.url, jwt_secret=b"\x02" * 32)
        out.append((bad.is_online(), bad.engine.state == engines.STATE_AUTH_FAILED))
        # an injected fault plays a dropped connection: offline, then the
        # cooldown holds the next upcheck back, then it recovers
        fi.install("engine.request", "error", first_n=1)
        try:
            with pytest.raises(el_mod.EngineOffline):
                el.engine.request(lambda api: api.exchange_capabilities())
        finally:
            fi.clear()
        out.append(el.engine.state)
        el.engine._last_upcheck = __import__("time").monotonic()
        out.append(el.engine.upcheck())
        el.engine._last_upcheck = 0.0
        out.append((el.engine.upcheck(), el.engine.state))
        port = int(rec.server.url.rsplit(":", 1)[1])
    gone = el_mod.ExecutionLayer(url=f"http://127.0.0.1:{port}", jwt_secret=SECRET, timeout=0.3)
    out.append((gone.is_online(), gone.engine.state))
    with pytest.raises(el_mod.EngineOffline):
        gone.engine.request(lambda api: api.exchange_capabilities())
    return out


def test_engine_state_machine_matches_jax():
    got = machine_run("port")
    assert got == machine_run("jax")
    assert got == [("offline", True, "online"), (False, True), "offline", False,
                   (True, "online"), (False, "offline")]


# ------------------------------------------------------ chain integration


def el_harnesses(overrides, server_pkgs=("jax", "port")):
    """Both packages' fake-crypto harnesses, each chain's engine an
    ``ExecutionLayer`` to its own package's mock engine server."""
    jhs, phs = harnesses(overrides, validators=16)
    servers = [Recorded(pkg) for pkg in server_pkgs]
    jhs.chain.execution_engine = jel.ExecutionLayer(url=servers[0].server.url, jwt_secret=SECRET)
    phs.chain.execution_engine = pel.ExecutionLayer(url=servers[1].server.url, jwt_secret=SECRET)
    return jhs, phs, servers


@pytest.mark.parametrize("fork", ["capella", "electra"])
def test_imports_over_the_socket_match_jax(fork):
    """Blocks produced from and imported through the Engine API: the same
    roots and the same calls at both servers."""
    jhs, phs, (jrec, prec) = el_harnesses(FORKS[fork])
    try:
        with jax_backend("fake"):
            roots = phs.extend_chain(3)
            assert jhs.extend_chain(3) == roots
        assert prec.server.payloads_seen == jrec.server.payloads_seen == 3
        assert prec.server.fcu_seen == jrec.server.fcu_seen > 0
        assert [m for m, _ in prec.calls] == [m for m, _ in jrec.calls]
        version = "engine_newPayloadV4" if fork == "electra" else "engine_newPayloadV2"
        assert version in {m for m, _ in prec.calls}
        assert phs.head_state.as_ssz_bytes() == jhs.head_state.as_ssz_bytes()
    finally:
        jrec.server.stop()
        prec.server.stop()


@pytest.mark.parametrize("status", ["invalid", "syncing"])
def test_payload_status_matches_jax(status):
    """A payload the engine calls INVALID is refused (``BlockError``); one it
    calls SYNCING imports optimistically; both packages alike."""
    jhs, phs, (jrec, prec) = el_harnesses({})
    try:
        outcomes = []
        with jax_backend("fake"):
            for hs, rec in ((jhs, jrec), (phs, prec)):
                hs.extend_chain(1)
                hs.advance_slot()
                signed = hs.produce_signed_block()
                block_hash = bytes(signed.message.body.execution_payload.block_hash)
                getattr(rec.server, f"{status}_hashes").add(block_hash)
                try:
                    root = hs.chain.process_block(signed)
                except Exception as err:  # noqa: BLE001 — compared across packages
                    outcomes.append((type(err).__name__, str(err)))
                else:
                    outcomes.append((root, block_hash in hs.chain.execution_engine.optimistic_hashes,
                                     hs.head_root == root))
        assert outcomes[0] == outcomes[1]
        if status == "invalid":
            assert outcomes[1][0] == BlockError.__name__
        else:
            assert outcomes[1][1:] == (True, True)
    finally:
        jrec.server.stop()
        prec.server.stop()


def test_chain_survives_el_restart_like_jax():
    """The engine dies: production raises ``EngineOffline``; the engine comes
    back on its port: production and import go on (engines.rs recovery)."""
    def run(hs, pkg, el_mod):
        rec = Recorded(pkg)
        el = el_mod.ExecutionLayer(url=rec.server.url, jwt_secret=SECRET)
        hs.chain.execution_engine = el
        hs.extend_chain(2)
        port = int(rec.server.url.rsplit(":", 1)[1])
        rec.server.stop()
        slot = hs.advance_slot()
        with pytest.raises(el_mod.EngineOffline):
            hs.produce_signed_block(slot=slot)
        offline = el.engine.state
        revived = Recorded(pkg, port=port)
        try:
            el.engine._last_upcheck = 0.0
            signed = hs.produce_signed_block(slot=slot)
            root = hs.chain.process_block(signed)
            return offline, el.engine.state, root, hs.head_root == root
        finally:
            revived.server.stop()

    jhs, phs = harnesses({}, validators=16)
    with jax_backend("fake"):
        j_out = run(jhs, "jax", jel)
        p_out = run(phs, "port", pel)
    assert p_out == j_out
    assert p_out[:2] == ("offline", "online") and p_out[3]
