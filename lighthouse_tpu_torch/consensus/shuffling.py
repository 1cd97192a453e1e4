"""Spec swap-or-not shuffling (``consensus/swap_or_not_shuffle`` in the
reference, ``src/lib.rs:17-22``).

Two entry points, matching the reference crate:

- ``compute_shuffled_index(index, n, seed, rounds)`` — single-index walk, the
  literal spec algorithm.
- ``shuffle_list(values, seed, rounds)`` — whole-list shuffle, the fast path
  (``shuffle_list`` in the reference).  Vectorized with numpy: per round we
  hash one pivot plus ``ceil(n/256)`` position-chunk digests and apply the
  swap mask to the whole array at once — the per-round work is O(n/256)
  SHA-256 calls plus fused array ops instead of n scalar walks.

Invariant (tested): ``shuffle_list(values, seed)[i] ==
values[compute_shuffled_index(i, n, seed)]`` — the property the spec's
``compute_committee`` relies on, so committee construction can slice the
shuffled array directly.

A copy of the JAX package's ``lighthouse_tpu/consensus/shuffling.py``;
the device shuffle is ``ops/shuffle_device.py`` with its CUDA kernel
(``csrc/shuffle.cu``).
"""

from __future__ import annotations

from hashlib import sha256

import numpy as np


def compute_shuffled_index(index: int, index_count: int, seed: bytes, rounds: int) -> int:
    """Spec ``compute_shuffled_index``: forward walk of the swap-or-not network."""
    assert 0 <= index < index_count
    if index_count <= 1 or rounds == 0:
        return index
    for r in range(rounds):
        rb = bytes([r])
        pivot = int.from_bytes(sha256(seed + rb).digest()[:8], "little") % index_count
        flip = (pivot + index_count - index) % index_count
        position = max(index, flip)
        source = sha256(seed + rb + (position // 256).to_bytes(4, "little")).digest()
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) & 1:
            index = flip
    return index


def round_digest_table(seed: bytes, rounds: int, num_chunks: int,
                       index_count: int):
    """Per-round pivots and source digests for a swap-or-not network.

    Returns ``(pivots, digests)`` where ``pivots[r]`` is the round-``r``
    pivot and ``digests[r]`` is the round's ``num_chunks`` source digests
    laid out flat (``num_chunks * 32`` bytes): the byte covering
    ``position`` lives at flat offset ``position >> 3``, because chunk
    ``position // 256`` starts at byte ``32 * (position // 256)`` and the
    in-chunk offset is ``(position % 256) // 8``.  Hashes land directly in
    one preallocated buffer — no per-round ``b"".join`` churn.  Shared by
    the host ``shuffle_list`` fast path and the device-kernel host-side
    precompute (``ops/shuffle_device.py``).
    """
    pivots = np.empty(rounds, dtype=np.int64)
    digests = np.empty((rounds, num_chunks * 32), dtype=np.uint8)
    for r in range(rounds):
        rb = bytes([r])
        pivots[r] = int.from_bytes(
            sha256(seed + rb).digest()[:8], "little") % index_count
        row = digests[r]
        for c in range(num_chunks):
            row[c * 32:(c + 1) * 32] = np.frombuffer(
                sha256(seed + rb + c.to_bytes(4, "little")).digest(),
                dtype=np.uint8,
            )
    return pivots, digests


def shuffle_list(values, seed: bytes, rounds: int) -> np.ndarray:
    """Whole-list shuffle such that ``out[i] = values[compute_shuffled_index(i)]``.

    Each swap-or-not round is an involution; composing them on the *list* in
    decreasing round order yields the same permutation the single-index
    forward walk produces (see the reference's backward iteration in
    ``swap_or_not_shuffle/src/shuffle_list.rs``).
    """
    arr = np.asarray(values)
    n = arr.shape[0]
    if n <= 1 or rounds == 0:
        return arr.copy()
    i = np.arange(n, dtype=np.int64)
    num_chunks = (n + 255) // 256
    pivots, digests = round_digest_table(seed, rounds, num_chunks, n)
    for r in range(rounds - 1, -1, -1):
        flip = (pivots[r] - i) % n
        position = np.maximum(i, flip)
        # Flat digest layout: `position >> 3` replaces the two-step
        # `[position // 256, (position % 256) // 8]` chunk/offset math.
        byte = digests[r, position >> 3]
        bit = (byte >> (position & 7).astype(np.uint8)) & 1
        arr = np.where(bit.astype(bool), arr[flip], arr)
    return arr
