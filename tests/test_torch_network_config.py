"""The port's ``network_config/`` and ``monitoring/`` vs the JAX package's.

- ``network_config.load_yaml``, the port's own reader of the
  consensus-specs config format (the card's machine has no PyYAML), against
  ``yaml.safe_load`` on the vendored configs, the embedded ones and crafted
  files, value for value and type for type; what it does not read raises;
- the JAX package's ``test_network_config.py`` re-pointed at the port
  (embedded networks, the round trip, a testnet directory, the monitoring
  push, the process payloads), each spec also equal to the JAX package's
  ``spec_to_yaml`` text;
- ``test_spec_conformance.py::test_reference_testnet_dir_loads`` and
  ``::test_mainnet_config_yaml_fork_schedule`` on the port, the vendored
  ``mainnet_config.yaml`` read by the port's reader.

Every comparison is exact.
"""

import json
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch
import yaml

pytest.importorskip("jax")

from lighthouse_tpu import network_config as jnc  # noqa: E402
from lighthouse_tpu_torch.network_config import (  # noqa: E402
    EMBEDDED_CONFIGS,
    Eth2NetworkConfig,
    load_yaml,
    spec_from_yaml,
    spec_to_yaml,
)
from lighthouse_tpu_torch.types.spec import mainnet_spec  # noqa: E402
from test_torch_chain import port_cpu  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
CONFORMANCE = os.path.join(HERE, "vectors", "conformance")
VENDORED = {
    "testnet_dir": os.path.join(CONFORMANCE, "testnet_dir", "config.yaml"),
    "mainnet_config": os.path.join(CONFORMANCE, "presets", "mainnet_config.yaml"),
}

#: Crafted files: every scalar form the reader takes, beside PyYAML.
CRAFTED = {
    "hex": "A: 0x00000000\nB: 0x01000099\nC: '0x04000000'\nD: \"0x05000000\"\n"
           "E: 0x00000000219ab540356cBB839Cbe05303d7705Fa\n",
    "comments": "# head\n\nA: 12  # twelve\nB: 'x # not a comment'\nC: a#b\n  # indented comment\n",
    "far_future": "ELECTRA_FORK_EPOCH: 18446744073709551615\nBIG: "
                  "115792089237316195423570985008687907853269984665640564039457584007913129638912\n",
    "scalars": "N1: ~\nN2: null\nN3:\nT: true\nY: yes\nO: off\nF1: 1.5\nF2: .inf\nF3: -.inf\n"
               "F4: 1e3\nF5: 6.02e+23\nF6: 1:30.5\nI1: 0o17\nI2: 017\nI3: 0b101\nI4: -42\n"
               "I5: +7\nI6: 1_000\nI7: 1:30\nS1: mainnet\nS2: 'it''s'\nS3: \"tab\\tnew\\u00e9\"\n"
               "S4: 127.0.0.1:9000\nS5: enr:-IS4QHCYrYZb\n",
    "boot_enr": "- 127.0.0.1:9000\n- 'enr:-IS4QHCYrYZbAKO'\n# a comment\n- 10.0.0.2:9001\n",
    "document_start": "---\nPRESET_BASE: 'minimal'\n",
    "empty": "# only a comment\n\n",
}

#: What the reader must refuse rather than misread.
UNSUPPORTED = {
    "nested": "A:\n  B: 1\n",
    "flow_list": "A: [1, 2]\n",
    "flow_map": "A: {b: 1}\n",
    "anchor": "A: &x 1\n",
    "tag": "A: !!str 1\n",
    "block_scalar": "A: |\n  text\n",
    "list_in_map": "A: 1\n- 2\n",
    "map_in_list": "- 1\nA: 2\n",
    "value_mapping": "A: b: c\n",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def same(a, b) -> bool:
    """Equal values of equal types (NaN equal to NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


# ------------------------------------------------------------- the reader


@pytest.mark.parametrize("name", sorted(VENDORED))
def test_reader_matches_safe_load_on_vendored_configs(name):
    with open(VENDORED[name]) as f:
        text = f.read()
    assert same(load_yaml(text), yaml.safe_load(text))


@pytest.mark.parametrize("name", sorted(EMBEDDED_CONFIGS))
def test_reader_matches_safe_load_on_embedded_configs(name):
    text = EMBEDDED_CONFIGS[name]
    assert text == jnc.EMBEDDED_CONFIGS[name]
    assert same(load_yaml(text), yaml.safe_load(text))


@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_reader_matches_safe_load_on_crafted_files(name):
    text = CRAFTED[name]
    assert same(load_yaml(text), yaml.safe_load(text))


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_reader_refuses_what_it_does_not_read(name):
    with pytest.raises(ValueError):
        load_yaml(UNSUPPORTED[name])


# ----------------------------------- the JAX package's test_network_config


def test_embedded_mainnet_matches_known_schedule():
    cfg = Eth2NetworkConfig.constant("mainnet")
    spec = cfg.spec
    assert spec.seconds_per_slot == 12
    assert spec.altair_fork_epoch == 74240
    assert spec.capella_fork_epoch == 194048
    assert spec.deneb_fork_version == bytes.fromhex("04000000")
    assert spec.electra_fork_epoch is None  # FAR_FUTURE in the config
    assert spec.preset.sync_committee_size == 512
    assert spec_to_yaml(spec) == jnc.spec_to_yaml(jnc.Eth2NetworkConfig.constant("mainnet").spec)


def test_embedded_minimal():
    spec = Eth2NetworkConfig.constant("minimal").spec
    assert spec.seconds_per_slot == 6
    assert spec.preset.sync_committee_size == 32
    assert spec.min_genesis_active_validator_count == 64
    assert spec_to_yaml(spec) == jnc.spec_to_yaml(jnc.Eth2NetworkConfig.constant("minimal").spec)


def test_yaml_round_trip():
    spec = Eth2NetworkConfig.constant("mainnet").spec
    text = spec_to_yaml(spec)
    spec2 = spec_from_yaml(text)
    assert spec2.altair_fork_epoch == spec.altair_fork_epoch
    assert spec2.deneb_fork_version == spec.deneb_fork_version
    assert spec2.electra_fork_epoch is None
    assert spec2.seconds_per_slot == spec.seconds_per_slot
    assert spec_to_yaml(spec2) == jnc.spec_to_yaml(jnc.spec_from_yaml(text))


def test_testnet_dir_loading(tmp_path):
    (tmp_path / "config.yaml").write_text(
        "PRESET_BASE: 'minimal'\nCONFIG_NAME: 'devnet-7'\n"
        "SECONDS_PER_SLOT: 3\nALTAIR_FORK_EPOCH: 1\n"
        "ALTAIR_FORK_VERSION: 0x01000099\n"
    )
    (tmp_path / "boot_enr.yaml").write_text("- 127.0.0.1:9000\n")
    cfg = Eth2NetworkConfig.from_testnet_dir(str(tmp_path))
    assert cfg.spec.config_name == "devnet-7"
    assert cfg.spec.seconds_per_slot == 3
    assert cfg.spec.altair_fork_version == bytes.fromhex("01000099")
    assert cfg.bootnodes == ["127.0.0.1:9000"]
    jcfg = jnc.Eth2NetworkConfig.from_testnet_dir(str(tmp_path))
    assert spec_to_yaml(cfg.spec) == jnc.spec_to_yaml(jcfg.spec)
    assert cfg.bootnodes == jcfg.bootnodes


def test_unknown_network_rejected():
    with pytest.raises(KeyError):
        Eth2NetworkConfig.constant("nonet")


def test_monitoring_service_pushes_stats():
    from lighthouse_tpu_torch.chain import BeaconChainHarness
    from lighthouse_tpu_torch.crypto.bls.backends import set_backend
    from lighthouse_tpu_torch.monitoring import MonitoringService

    received = []

    class Sink(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            received.append(json.loads(self.rfile.read(length)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

    server = ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    set_backend("fake")
    try:
        harness = BeaconChainHarness(validator_count=8, fake_crypto=True)
        harness.extend_chain(2)
        url = f"http://127.0.0.1:{server.server_address[1]}/api/v1/client/metrics"
        svc = MonitoringService(endpoint=url, chain=harness.chain)
        assert svc.send_once()
        assert svc.sends == 1
        assert len(received[0]) == 2  # beaconnode + system in one POST
        payload = received[0][0]
        assert payload["process"] == "beaconnode"
        assert payload["sync_beacon_head_slot"] == 2
        # common ProcessMetrics block (monitoring_api/src/types.rs:64-70)
        assert payload["client_name"] == "lighthouse-tpu"
        assert payload["memory_process_bytes"] > 0
        sysp = received[0][1]
        assert sysp["process"] == "system"
        assert sysp["memory_node_bytes_total"] > 0
        assert sysp["cpu_threads"] >= 1
        assert sysp["misc_os"] == "lin"
        # a dead endpoint must not raise
        svc_dead = MonitoringService(
            endpoint="http://127.0.0.1:1/nothing", chain=harness.chain
        )
        assert not svc_dead.send_once()
        assert svc_dead.last_error
    finally:
        server.shutdown()
        server.server_close()


def test_system_health_observations():
    """system_health reads /proc without ever raising; core fields are
    populated on this (Linux) box."""
    from lighthouse_tpu_torch.system_health import (
        ProcessHealth,
        SystemHealth,
        observe_all,
    )

    ph = ProcessHealth.observe()
    assert ph.pid > 0
    assert ph.pid_num_threads >= 1
    assert ph.pid_mem_resident_set_size > 0
    sh = SystemHealth.observe()
    assert sh.cpu_threads >= 1
    assert sh.sys_virt_mem_total > 0
    assert sh.disk_node_bytes_total > 0
    assert sh.misc_node_boot_ts_seconds > 0
    flat = observe_all()
    assert flat["pid"] == ph.pid
    assert "network_node_bytes_total_received" in flat


def test_validator_process_payload():
    from lighthouse_tpu.monitoring import collect_validator_stats as j_collect
    from lighthouse_tpu_torch.monitoring import collect_validator_stats

    class FakeVC:
        validators = ["a", "b", "c"]

    p = collect_validator_stats(FakeVC())
    assert p["process"] == "validator"
    assert p["validator_total"] == 3
    assert p["client_name"] == "lighthouse-tpu"
    assert sorted(p) == sorted(j_collect(FakeVC()))


# ------------------------------- the JAX package's test_spec_conformance


def test_reference_testnet_dir_loads():
    """The reference's own environment-test testnet_dir (a mainnet-preset
    config with a customised genesis count) loads through the port's
    --testnet-dir path and yields the customised spec."""
    cfg = Eth2NetworkConfig.from_testnet_dir(os.path.dirname(VENDORED["testnet_dir"]))
    spec = cfg.spec
    assert spec.preset.name == "mainnet"
    assert spec.min_genesis_active_validator_count == 100000  # customised
    assert spec.genesis_fork_version == bytes.fromhex("00000000")
    assert spec.seconds_per_slot == 12
    jcfg = jnc.Eth2NetworkConfig.from_testnet_dir(os.path.dirname(VENDORED["testnet_dir"]))
    assert spec_to_yaml(spec) == jnc.spec_to_yaml(jcfg.spec)


def test_mainnet_config_yaml_fork_schedule():
    """The port's runtime config (fork versions/epochs, timing) vs the
    network config the reference embeds for mainnet, read by the port's
    reader."""
    spec = mainnet_spec()
    with open(VENDORED["mainnet_config"]) as f:
        cfg = load_yaml(f.read())
    checks = {
        "SECONDS_PER_SLOT": spec.seconds_per_slot,
        "SECONDS_PER_ETH1_BLOCK": spec.seconds_per_eth1_block,
        "ETH1_FOLLOW_DISTANCE": spec.eth1_follow_distance,
        "MIN_GENESIS_ACTIVE_VALIDATOR_COUNT": spec.min_genesis_active_validator_count,
        "GENESIS_DELAY": spec.genesis_delay,
        "GENESIS_FORK_VERSION": spec.genesis_fork_version,
        "ALTAIR_FORK_VERSION": spec.altair_fork_version,
        "ALTAIR_FORK_EPOCH": spec.altair_fork_epoch,
        "BELLATRIX_FORK_VERSION": spec.bellatrix_fork_version,
        "BELLATRIX_FORK_EPOCH": spec.bellatrix_fork_epoch,
        "CAPELLA_FORK_VERSION": spec.capella_fork_version,
        "CAPELLA_FORK_EPOCH": spec.capella_fork_epoch,
        "DENEB_FORK_VERSION": spec.deneb_fork_version,
        "DENEB_FORK_EPOCH": spec.deneb_fork_epoch,
        "MIN_PER_EPOCH_CHURN_LIMIT": spec.min_per_epoch_churn_limit,
        "CHURN_LIMIT_QUOTIENT": spec.churn_limit_quotient,
        "EJECTION_BALANCE": spec.ejection_balance,
        "SHARD_COMMITTEE_PERIOD": spec.shard_committee_period,
        "MIN_VALIDATOR_WITHDRAWABILITY_DELAY": spec.min_validator_withdrawability_delay,
    }
    mismatches = []
    for key, ours in checks.items():
        if key not in cfg:
            mismatches.append(f"{key}: absent from config.yaml")
            continue
        theirs = cfg[key]
        if isinstance(ours, bytes):
            # an unquoted 0x... scalar reads as an int, as PyYAML reads it
            ours = int.from_bytes(ours, "big")
        elif ours is None:
            ours = 2**64 - 1
        if ours != theirs:
            mismatches.append(f"{key}: ours={ours!r} yaml={theirs!r}")
    assert not mismatches, "\n".join(mismatches)
