"""Embedded network configurations + YAML config loading.

Equivalent of the reference's ``common/eth2_network_config`` (embedded
mainnet/testnet ``config.yaml`` + bootnodes, built from
``eth2_config::Eth2Config``) and the runtime-YAML side of ``ChainSpec``
(`consensus/types/src/chain_spec.rs` ``from_yaml``): a node can boot from
`--network mainnet|minimal` (embedded) or ``--testnet-dir`` holding a spec
``config.yaml``.

A copy of the JAX package's ``lighthouse_tpu/network_config/__init__.py``,
but for its ``yaml.safe_load``: the card's machine has no PyYAML, so
:func:`load_yaml` parses the consensus-specs config format itself (a flat
``KEY: value`` mapping or a ``- item`` list, comments, quoted scalars), and
resolves plain scalars by PyYAML's YAML 1.1 rules (an unquoted
``0x00000000`` is the int 0, ``yes`` a bool, ``~`` null).  Anything outside
that subset (nesting, flow collections, anchors, tags, block scalars)
raises ``ValueError`` instead of being misread.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

from ..types.spec import MAINNET_PRESET, MINIMAL_PRESET, ChainSpec, minimal_spec

# ------------------------------------------------------------ the YAML subset
# PyYAML's implicit resolvers for plain scalars (resolver.py, YAML 1.1).
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_TRUE = {"yes", "true", "on"}
#: First characters that start YAML syntax this parser does not take.
_UNSUPPORTED = set("[]{}&*!|>%@`")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
            "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ", "P": " "}


def _sexagesimal(value: str, conv):
    digits = [conv(part) for part in value.split(":")]
    digits.reverse()
    base, out = 1, 0
    for d in digits:
        out += d * base
        base *= 60
    return out


def _construct_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _plain(value: str):
    """A plain scalar resolved as PyYAML's SafeLoader resolves it."""
    if _NULL.match(value):
        return None
    if _BOOL.match(value):
        return value.lower() in _TRUE
    if _INT.match(value):
        return _construct_int(value)
    if _FLOAT.match(value):
        return _construct_float(value)
    return value


def _double_quoted(body: str, line_no: int) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        esc = body[i + 1:i + 2]
        widths = {"x": 2, "u": 4, "U": 8}
        if esc in widths:
            code = body[i + 2:i + 2 + widths[esc]]
            if len(code) != widths[esc] or not all(ch in "0123456789abcdefABCDEF" for ch in code):
                raise ValueError(f"line {line_no}: bad escape \\{esc}{code}")
            out.append(chr(int(code, 16)))
            i += 2 + widths[esc]
        elif esc in _ESCAPES:
            out.append(_ESCAPES[esc])
            i += 2
        else:
            raise ValueError(f"line {line_no}: unknown escape \\{esc}")
    return "".join(out)


def _scalar(text: str, line_no: int):
    """One scalar with its trailing comment: quoted (a string) or plain
    (resolved)."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        quote = text[0]
        i = 1
        while True:
            j = text.find(quote, i)
            if j < 0:
                raise ValueError(f"line {line_no}: unterminated quoted scalar")
            if quote == "'" and text[j + 1:j + 2] == "'":
                i = j + 2  # '' is an escaped quote
                continue
            if quote == '"':
                slashes = len(text[i:j]) - len(text[i:j].rstrip("\\"))
                if slashes % 2:
                    i = j + 1  # \" is an escaped quote
                    continue
            break
        rest = text[j + 1:].strip()
        if rest and not rest.startswith("#"):
            raise ValueError(f"line {line_no}: text after a quoted scalar: {rest!r}")
        body = text[1:j]
        if quote == "'":
            return body.replace("''", "'")
        return _double_quoted(body, line_no)
    # a comment starts at a '#' that follows whitespace
    m = re.search(r"\s#", text)
    if m is not None:
        text = text[:m.start()].rstrip()
    if text.startswith("#"):
        text = ""
    if text[:1] in _UNSUPPORTED or ": " in text or text.endswith(":") or (
            text[:1] in "-?:" and text[1:2] in (" ", "") and text != ""):
        raise ValueError(f"line {line_no}: unsupported YAML {text!r}")
    return _plain(text)


def load_yaml(text: str):
    """Parse a consensus-specs config file as ``yaml.safe_load`` does: a flat
    mapping of scalars, a list of scalars, or None for an empty document."""
    mapping: Optional[dict] = None
    items: Optional[list] = None
    started = False
    for line_no, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        stripped = line.lstrip()
        if not stripped or stripped.startswith("#"):
            continue
        if line == "---" and not started:
            started = True
            continue
        started = True
        if "\t" in line[:len(line) - len(stripped)] or line != stripped:
            raise ValueError(f"line {line_no}: indented or nested YAML is not supported")
        if stripped == "-" or stripped.startswith("- "):
            if mapping is not None:
                raise ValueError(f"line {line_no}: a list item inside a mapping")
            items = [] if items is None else items
            items.append(_scalar(stripped[1:], line_no))
            continue
        if items is not None:
            raise ValueError(f"line {line_no}: a mapping entry inside a list")
        if stripped[:1] in ("'", '"'):
            raise ValueError(f"line {line_no}: quoted keys are not supported")
        m = re.match(r"^([^#:]+?):(?:\s+(.*))?$", stripped)
        if m is None:
            raise ValueError(f"line {line_no}: not a `KEY: value` line: {stripped!r}")
        key = _scalar(m.group(1), line_no)
        value = m.group(2)
        mapping = {} if mapping is None else mapping
        mapping[key] = None if value is None else _scalar(value, line_no)
    if mapping is not None:
        return mapping
    return items


# YAML key (consensus-specs configs/*.yaml) -> ChainSpec field
_YAML_FIELDS = {
    "SECONDS_PER_SLOT": ("seconds_per_slot", int),
    "GENESIS_DELAY": ("genesis_delay", int),
    "MIN_GENESIS_TIME": ("min_genesis_time", int),
    "MIN_GENESIS_ACTIVE_VALIDATOR_COUNT": ("min_genesis_active_validator_count", int),
    "ETH1_FOLLOW_DISTANCE": ("eth1_follow_distance", int),
    "SECONDS_PER_ETH1_BLOCK": ("seconds_per_eth1_block", int),
    "GENESIS_FORK_VERSION": ("genesis_fork_version", bytes),
    "ALTAIR_FORK_VERSION": ("altair_fork_version", bytes),
    "ALTAIR_FORK_EPOCH": ("altair_fork_epoch", int),
    "BELLATRIX_FORK_VERSION": ("bellatrix_fork_version", bytes),
    "BELLATRIX_FORK_EPOCH": ("bellatrix_fork_epoch", int),
    "CAPELLA_FORK_VERSION": ("capella_fork_version", bytes),
    "CAPELLA_FORK_EPOCH": ("capella_fork_epoch", int),
    "DENEB_FORK_VERSION": ("deneb_fork_version", bytes),
    "DENEB_FORK_EPOCH": ("deneb_fork_epoch", int),
    "ELECTRA_FORK_VERSION": ("electra_fork_version", bytes),
    "ELECTRA_FORK_EPOCH": ("electra_fork_epoch", int),
    "CHURN_LIMIT_QUOTIENT": ("churn_limit_quotient", int),
    "SHARD_COMMITTEE_PERIOD": ("shard_committee_period", int),
    "MIN_VALIDATOR_WITHDRAWABILITY_DELAY": ("min_validator_withdrawability_delay", int),
}

FAR_FUTURE_EPOCH_YAML = 2**64 - 1


def spec_from_yaml(text: str) -> ChainSpec:
    """Build a ``ChainSpec`` from a consensus-specs ``config.yaml``
    (reference ``ChainSpec::from_yaml``).  Unknown keys are ignored (the
    spec config files carry many constants the preset already fixes)."""
    obj = load_yaml(text) or {}
    preset_base = str(obj.get("PRESET_BASE", "mainnet")).strip("'\"")
    preset = MINIMAL_PRESET if preset_base == "minimal" else MAINNET_PRESET
    base = (
        minimal_spec() if preset_base == "minimal"
        else ChainSpec(preset=preset, config_name=str(obj.get("CONFIG_NAME", preset_base)))
    )
    overrides = {}
    for key, (field, conv) in _YAML_FIELDS.items():
        if key not in obj:
            continue
        raw = obj[key]
        if conv is bytes:
            if isinstance(raw, int):
                # yaml parses 0x-prefixed scalars as integers
                overrides[field] = raw.to_bytes(4, "big")
            else:
                s = str(raw)
                overrides[field] = bytes.fromhex(s[2:] if s.startswith("0x") else s)
        else:
            value = int(raw)
            if field.endswith("_fork_epoch") and value == FAR_FUTURE_EPOCH_YAML:
                overrides[field] = None  # not scheduled
            else:
                overrides[field] = value
    overrides["config_name"] = str(obj.get("CONFIG_NAME", base.config_name))
    return dataclasses.replace(base, **overrides)


def spec_to_yaml(spec: ChainSpec) -> str:
    """Round-trip serialization (the ``/eth/v1/config/spec`` subset the
    reference writes back out)."""
    lines = [f"PRESET_BASE: '{'minimal' if spec.preset is MINIMAL_PRESET else 'mainnet'}'",
             f"CONFIG_NAME: '{spec.config_name}'"]
    for key, (field, conv) in _YAML_FIELDS.items():
        value = getattr(spec, field)
        if conv is bytes:
            lines.append(f"{key}: 0x{value.hex()}")
        elif value is None:
            lines.append(f"{key}: {FAR_FUTURE_EPOCH_YAML}")
        else:
            lines.append(f"{key}: {value}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------- embedded network presets
# The reference embeds config+genesis+bootnodes per supported network
# (common/eth2_network_config/built_in_network_configs).  Genesis states are
# fetched via checkpoint sync in this stack; configs + bootnodes embed here.

_MAINNET_CONFIG_YAML = """
PRESET_BASE: 'mainnet'
CONFIG_NAME: 'mainnet'
MIN_GENESIS_ACTIVE_VALIDATOR_COUNT: 16384
MIN_GENESIS_TIME: 1606824000
GENESIS_FORK_VERSION: 0x00000000
GENESIS_DELAY: 604800
ALTAIR_FORK_VERSION: 0x01000000
ALTAIR_FORK_EPOCH: 74240
BELLATRIX_FORK_VERSION: 0x02000000
BELLATRIX_FORK_EPOCH: 144896
CAPELLA_FORK_VERSION: 0x03000000
CAPELLA_FORK_EPOCH: 194048
DENEB_FORK_VERSION: 0x04000000
DENEB_FORK_EPOCH: 269568
ELECTRA_FORK_VERSION: 0x05000000
ELECTRA_FORK_EPOCH: 18446744073709551615
SECONDS_PER_SLOT: 12
SECONDS_PER_ETH1_BLOCK: 14
MIN_VALIDATOR_WITHDRAWABILITY_DELAY: 256
SHARD_COMMITTEE_PERIOD: 256
ETH1_FOLLOW_DISTANCE: 2048
CHURN_LIMIT_QUOTIENT: 65536
"""

_MINIMAL_CONFIG_YAML = """
PRESET_BASE: 'minimal'
CONFIG_NAME: 'minimal'
MIN_GENESIS_ACTIVE_VALIDATOR_COUNT: 64
MIN_GENESIS_TIME: 1578009600
GENESIS_FORK_VERSION: 0x00000001
GENESIS_DELAY: 300
SECONDS_PER_SLOT: 6
SECONDS_PER_ETH1_BLOCK: 14
ETH1_FOLLOW_DISTANCE: 16
CHURN_LIMIT_QUOTIENT: 32
SHARD_COMMITTEE_PERIOD: 64
MIN_VALIDATOR_WITHDRAWABILITY_DELAY: 256
"""

EMBEDDED_CONFIGS: Dict[str, str] = {
    "mainnet": _MAINNET_CONFIG_YAML,
    "minimal": _MINIMAL_CONFIG_YAML,
}

# libp2p-era ENR bootnodes would go here; this stack's transport dials
# host:port peers directly (CLI --peer), so bootnodes are (host, port) pairs.
EMBEDDED_BOOTNODES: Dict[str, List[str]] = {
    "mainnet": [],
    "minimal": [],
}


class Eth2NetworkConfig:
    """A network bundle (reference ``Eth2NetworkConfig``): spec + bootnodes,
    from an embedded preset or a testnet directory."""

    def __init__(self, spec: ChainSpec, bootnodes: Optional[List[str]] = None):
        self.spec = spec
        self.bootnodes = list(bootnodes or [])

    @classmethod
    def constant(cls, name: str) -> "Eth2NetworkConfig":
        if name not in EMBEDDED_CONFIGS:
            raise KeyError(f"unknown network {name!r} (have: {sorted(EMBEDDED_CONFIGS)})")
        return cls(spec_from_yaml(EMBEDDED_CONFIGS[name]),
                   EMBEDDED_BOOTNODES.get(name, []))

    @classmethod
    def from_testnet_dir(cls, path: str) -> "Eth2NetworkConfig":
        import os

        with open(os.path.join(path, "config.yaml")) as f:
            spec = spec_from_yaml(f.read())
        bootnodes: List[str] = []
        boot_path = os.path.join(path, "boot_enr.yaml")
        if os.path.exists(boot_path):
            with open(boot_path) as f:
                bootnodes = [str(b) for b in (load_yaml(f.read()) or [])]
        return cls(spec, bootnodes)
