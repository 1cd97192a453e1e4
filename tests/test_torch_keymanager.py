"""The port's keymanager API (``validator_client/keymanager.py``) and
Web3Signer remote signing (``validator_client/web3signer.py``) vs the JAX
package's.

- The JAX package's ``test_keymanager.py`` re-pointed at the port, but for
  ``test_validator_manager_cli_roundtrip``: ``cli.py`` is not ported yet;
- interop: the JAX package's ``KeymanagerClient`` imports a keystore the
  JAX package encrypted into the port's server, and the port's client one
  the port encrypted into the JAX package's server; both list, sign with
  and delete it alike.
"""

import json
import urllib.error

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu_torch.consensus.genesis import interop_secret_key  # noqa: E402
from lighthouse_tpu_torch.crypto import keystore as ks  # noqa: E402
from lighthouse_tpu_torch.types.spec import minimal_spec  # noqa: E402
from lighthouse_tpu_torch.validator_client.keymanager import (  # noqa: E402
    KeymanagerClient,
    KeymanagerServer,
)
from lighthouse_tpu_torch.validator_client.validator_store import ValidatorStore  # noqa: E402
from lighthouse_tpu_torch.validator_client.web3signer import MockWeb3Signer  # noqa: E402

GVR = b"\x42" * 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spec():
    return minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                        capella_fork_epoch=0, deneb_fork_epoch=None)


@pytest.fixture()
def rig():
    store = ValidatorStore(keys=[interop_secret_key(0)], spec=_spec(),
                           genesis_validators_root=GVR)
    server = KeymanagerServer(store=store, genesis_validators_root=GVR).start()
    client = KeymanagerClient(server.url, server.token, timeout=30.0)
    yield store, server, client
    server.stop()


def _mk_keystore(index: int, password: str, fast: bool = False):
    wallet, _ = ks.create_wallet(f"w{index}", "walletpass", _test_fast_kdf=fast)
    return ks.derive_validator_keystores(wallet, "walletpass", password, 1,
                                         _test_fast_kdf=fast)[0][0]


def test_keymanager_auth_required(rig):
    store, server, client = rig
    with pytest.raises(urllib.error.HTTPError) as ei:
        KeymanagerClient(server.url, "wrong-token").list_keystores()
    assert ei.value.code == 401


def test_keystore_lifecycle_over_api(rig):
    """Import (at the default scrypt work factor), list, delete twice; the
    deletion exports the protection history."""
    store, server, client = rig
    assert len(client.list_keystores()) == 1
    keystore = _mk_keystore(1, "pw1")
    statuses = client.import_keystores([keystore], ["pw1"])
    assert statuses[0]["status"] == "imported"
    assert len(client.list_keystores()) == 2
    new_pk = bytes.fromhex(keystore["pubkey"])
    assert store.has_key(new_pk)
    resp = client.delete_keystores([new_pk])
    assert resp["data"][0]["status"] == "deleted"
    assert not store.has_key(new_pk)
    resp2 = client.delete_keystores([new_pk])
    assert resp2["data"][0]["status"] == "not_found"
    assert json.loads(resp2["slashing_protection"])["metadata"]


def test_import_reports_bad_password_and_takes_interchange(rig):
    store, server, client = rig
    keystore = _mk_keystore(3, "right", fast=True)
    assert client.import_keystores([keystore], ["wrong"])[0]["status"] == "error"
    assert not store.has_key(bytes.fromhex(keystore["pubkey"]))
    pk = bytes.fromhex(keystore["pubkey"])
    history = json.dumps({
        "metadata": {"interchange_format_version": "5",
                     "genesis_validators_root": "0x" + GVR.hex()},
        "data": [{"pubkey": "0x" + pk.hex(), "signed_blocks": [{"slot": "9"}],
                  "signed_attestations": []}]})
    assert client.import_keystores([keystore], ["right"], history)[0]["status"] == "imported"
    from lighthouse_tpu_torch.validator_client import SlashingProtectionError

    with pytest.raises(SlashingProtectionError):
        store.slashing_db.check_and_insert_block_proposal(pk, 9, b"\x01" * 32)


def test_remote_keys_sign_byte_identical_to_local(rig):
    store, server, client = rig
    sk = interop_secret_key(7)
    pk = sk.public_key().to_bytes()
    signer = MockWeb3Signer([sk]).start()
    try:
        statuses = client.import_remotekeys([{"pubkey": "0x" + pk.hex(), "url": signer.url}])
        assert statuses[0]["status"] == "imported"
        assert store.has_key(pk)
        root = b"\x13" * 32
        assert store._raw_sign(pk, root) == sk.sign(root).to_bytes()
        assert signer.sign_requests == 1
        rows = client.list_remotekeys()
        assert rows and rows[0]["url"] == signer.url
        resp = client._request("DELETE", "/eth/v1/remotekeys", {"pubkeys": ["0x" + pk.hex()]})
        assert resp["data"][0]["status"] == "deleted" and not store.has_key(pk)
    finally:
        signer.stop()


def test_per_validator_settings_routes(rig):
    """feerecipient, gas_limit and graffiti per validator: GET, POST and
    DELETE, live in the client's services."""
    from lighthouse_tpu_torch.validator_client.services import (
        BeaconNodeFallback,
        BlockService,
        DutiesService,
        PreparationService,
    )

    store, server, client = rig
    pk = store.pubkeys[0]
    hexkey = "0x" + pk.hex()

    class _NoBn:
        base_url = "http://127.0.0.1:1"

    fallback = BeaconNodeFallback([_NoBn()])
    duties = DutiesService(store=store, fallback=fallback)
    prep = PreparationService(store=store, duties=duties, fallback=fallback)
    blocks = BlockService(store=store, duties=duties, fallback=fallback, types=None)
    server.preparation, server.blocks = prep, blocks

    route = f"/eth/v1/validator/{hexkey}"
    assert client._request("GET", f"{route}/feerecipient")["data"]["ethaddress"] == \
        "0x" + "00" * 20
    client._request("POST", f"{route}/feerecipient", {"ethaddress": "0x" + "42" * 20})
    assert prep.per_validator[pk] == b"\x42" * 20
    assert client._request("GET", f"{route}/feerecipient")["data"]["ethaddress"] == \
        "0x" + "42" * 20
    client._request("DELETE", f"{route}/feerecipient")
    assert pk not in prep.per_validator
    client._request("POST", f"{route}/gas_limit", {"gas_limit": "25000000"})
    assert client._request("GET", f"{route}/gas_limit")["data"]["gas_limit"] == "25000000"
    client._request("POST", f"{route}/graffiti", {"graffiti": "km-set"})
    assert blocks._graffiti_for(pk).rstrip(b"\x00") == b"km-set"
    assert client._request("GET", f"{route}/graffiti")["data"]["graffiti"] == "km-set"
    client._request("DELETE", f"{route}/graffiti")
    assert blocks._graffiti_for(pk) == blocks.graffiti
    with pytest.raises(urllib.error.HTTPError):
        client._request("GET", f"/eth/v1/validator/0x{'ee' * 48}/feerecipient")


@pytest.mark.parametrize("direction", ["jax_into_port", "port_into_jax"])
def test_keymanager_interop_with_jax(direction):
    from lighthouse_tpu.crypto import keystore as jks
    from lighthouse_tpu.types.spec import minimal_spec as j_minimal_spec
    from lighthouse_tpu.validator_client.keymanager import KeymanagerClient as JKClient
    from lighthouse_tpu.validator_client.keymanager import KeymanagerServer as JKServer
    from lighthouse_tpu.validator_client.validator_store import ValidatorStore as JStore

    secret = interop_secret_key(5).scalar.to_bytes(32, "big")
    pk = interop_secret_key(5).public_key().to_bytes()
    if direction == "jax_into_port":
        keystore = jks.encrypt(secret, "pw", pubkey=pk, _test_fast_kdf=True)
        store = ValidatorStore(keys=[], spec=_spec(), genesis_validators_root=GVR)
        server = KeymanagerServer(store=store, genesis_validators_root=GVR).start()
        client_cls = JKClient
    else:
        keystore = ks.encrypt(secret, "pw", pubkey=pk, _test_fast_kdf=True)
        spec = j_minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                              capella_fork_epoch=0, deneb_fork_epoch=None)
        store = JStore(keys=[], spec=spec, genesis_validators_root=GVR)
        server = JKServer(store=store, genesis_validators_root=GVR).start()
        client_cls = KeymanagerClient
    try:
        client = client_cls(server.url, server.token, timeout=30.0)
        assert client.import_keystores([keystore], ["pw"])[0]["status"] == "imported"
        assert [k["validating_pubkey"] for k in client.list_keystores()] == ["0x" + pk.hex()]
        root = b"\x31" * 32
        assert store._raw_sign(pk, root) == interop_secret_key(5).sign(root).to_bytes()
        assert client.delete_keystores([pk])["data"][0]["status"] == "deleted"
    finally:
        server.stop()
