"""Field-by-field container diff for tests and tooling.

Equivalent of the reference's ``common/compare_fields`` (+ derive): when
two states (or any SSZ containers) disagree, a root mismatch tells you
nothing — this walks the field tree and names exactly WHICH leaves differ,
the form the reference's store/transition tests print on failure.

A copy of the JAX package's ``lighthouse_tpu/types/compare_fields.py``.
"""

from __future__ import annotations

from typing import Any, List


def _is_container(v: Any) -> bool:
    return hasattr(v, "fields") and hasattr(v, "hash_tree_root")


def _fmt(v: Any) -> str:
    if isinstance(v, (bytes, bytearray)):
        h = bytes(v).hex()
        return "0x" + (h if len(h) <= 18 else h[:16] + "…")
    s = repr(v)
    return s if len(s) <= 48 else s[:45] + "…"


def compare_fields(a: Any, b: Any, path: str = "", *,
                   max_diffs: int = 32) -> List[str]:
    """Dotted paths of every differing leaf between two containers (or
    values), e.g. ``balances[3]: 32000000000 != 31999999999``.  Bounded by
    ``max_diffs`` so a wholesale mismatch stays readable."""
    diffs: List[str] = []
    _walk(a, b, path, diffs, max_diffs)
    return diffs


def _walk(a: Any, b: Any, path: str, diffs: List[str], max_diffs: int) -> None:
    if len(diffs) >= max_diffs:
        return
    if type(a) is not type(b):
        diffs.append(f"{path or '<root>'}: type {type(a).__name__} != "
                     f"{type(b).__name__}")
        return
    if _is_container(a):
        for name in a.fields:
            _walk(getattr(a, name), getattr(b, name),
                  f"{path}.{name}" if path else name, diffs, max_diffs)
        return
    if isinstance(a, (list, tuple)) or (
            hasattr(a, "__len__") and hasattr(a, "__getitem__")
            and not isinstance(a, (bytes, bytearray, str))):
        if len(a) != len(b):
            diffs.append(f"{path}: length {len(a)} != {len(b)}")
            # keep walking the shared prefix — the first divergent entry
            # is usually the real story
        for i in range(min(len(a), len(b))):
            _walk(a[i], b[i], f"{path}[{i}]", diffs, max_diffs)
            if len(diffs) >= max_diffs:
                return
        return
    if isinstance(a, (bytes, bytearray)):
        if bytes(a) != bytes(b):
            diffs.append(f"{path}: {_fmt(a)} != {_fmt(b)}")
        return
    try:
        equal = bool(a == b)
    except TypeError:
        equal = a is b  # non-comparable same-type leaves: identity only
    if not equal:
        diffs.append(f"{path}: {_fmt(a)} != {_fmt(b)}")


def assert_states_equal(a: Any, b: Any) -> None:
    """Raise with the NAMED differing fields (reference compare_fields'
    test usage) instead of a bare root mismatch."""
    if bytes(a.hash_tree_root()) == bytes(b.hash_tree_root()):
        return
    diffs = compare_fields(a, b)
    raise AssertionError(
        "states differ at %d field(s):\n  %s" % (len(diffs), "\n  ".join(diffs))
        if diffs else
        "state roots differ but no field diff found (caching bug?)"
    )
