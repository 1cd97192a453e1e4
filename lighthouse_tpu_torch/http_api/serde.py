"""Beacon-API JSON (de)serialization for SSZ containers.

The beacon API encodes uint64 as decimal strings, byte vectors as 0x-hex,
bitlists/bitvectors as 0x-hex SSZ bytes, and containers as objects — this
module derives all of that generically from the container's SSZ type
descriptors (reference: the serde derives across ``consensus/types``).

Encoding is type-driven: bit fields reuse the descriptor's own SSZ
``serialize``/``deserialize`` so Bitvector fields carry no bitlist delimiter
bit and an empty Bitlist round-trips as ``0x01``.

A copy of the JAX package's ``lighthouse_tpu/http_api/serde.py``.
"""

from __future__ import annotations

from typing import Any, Optional

from ..types import ssz as ssz_mod

_HEX_TYPES = (ssz_mod.Bitlist, ssz_mod.Bitvector, ssz_mod.ByteVector, ssz_mod.ByteList)


def to_json(value: Any, ftype: Optional[ssz_mod.SszType] = None) -> Any:
    if isinstance(value, ssz_mod.Container):
        return {
            name: to_json(getattr(value, name), ft) for name, ft in value.fields.items()
        }
    if isinstance(ftype, _HEX_TYPES):
        return "0x" + ftype.serialize(value).hex()
    if isinstance(value, bool):
        return value
    if isinstance(value, int):
        return str(value)
    if isinstance(value, (bytes, bytearray)):
        return "0x" + bytes(value).hex()
    if isinstance(value, (list, tuple)):
        elem = getattr(ftype, "elem", None)
        if elem is None and value and all(isinstance(b, bool) for b in value):
            # Untyped bool list: assume bitlist (SSZ hex with delimiter).
            return "0x" + ssz_mod.Bitlist(len(value)).serialize(list(value)).hex()
        return [to_json(v, elem) for v in value]
    return value


def container_from_json(cls, obj: dict):
    """Inverse of ``to_json`` for containers (sufficient for the API
    surface's POST bodies; SSZ octet-stream is the preferred wire format)."""
    kwargs = {}
    for name, ftype in cls.fields.items():
        kwargs[name] = _field_from_json(ftype, obj[name])
    return cls(**kwargs)


def _field_from_json(ftype, v):
    if isinstance(ftype, ssz_mod.BooleanType):
        return v if isinstance(v, bool) else v in ("true", "1", 1)
    if isinstance(ftype, ssz_mod.UintType):
        return int(v)
    if isinstance(ftype, (ssz_mod.Bitlist, ssz_mod.Bitvector)):
        return ftype.deserialize(bytes.fromhex(v[2:]))
    if isinstance(v, str) and v.startswith("0x"):
        return bytes.fromhex(v[2:])
    if isinstance(ftype, ssz_mod._ContainerType):
        return container_from_json(ftype.cls, v)
    if isinstance(v, dict):
        # nested container via a wrapper type exposing the class
        cls = getattr(ftype, "container_class", None) or getattr(ftype, "cls", None)
        if cls is not None:
            return container_from_json(cls, v)
    if isinstance(v, list):
        return [_field_from_json(getattr(ftype, "elem", None), x) for x in v]
    return v
