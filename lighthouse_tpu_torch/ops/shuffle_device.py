"""Epoch-boundary consensus on the card: swap-or-not shuffling, proposer
selection, and the fused whole-epoch dispatch.

The port of ``lighthouse_tpu/ops/shuffle_device.py``.  The reference
isolates ``swap_or_not_shuffle`` as a pure bit-twiddling kernel
(``consensus/swap_or_not_shuffle/src/shuffle_list.rs``) because it
dominates epoch-boundary CPU after signature work.  This module puts that
last O(validators) Python on the card:

- :func:`_shuffle_kernel` — the whole-list swap-or-not network.  Per round
  the host precomputes one pivot plus the chunk digest row (via the same
  ``round_digest_table`` seam the numpy fast path uses, laid out flat so
  the byte covering ``position`` is ``digests[r, position >> 3]``), and the
  hand-written CUDA kernel ``csrc/shuffle.cu:shuffle_round_kernel``
  applies the swap mask to every lane, one launch a round
  (``ops/cuda_epoch.py``).  Round rows arrive host-reversed, so the
  rounds walk the table forward.
- :func:`_proposer_kernel` — the spec's rejection-sampling candidate walk,
  over (slot, candidate) lanes.  The per-round source digest depends on
  each lane's current position, so it is hashed on the card by
  ``csrc/shuffle.cu:proposer_walk_kernel``: the 37-byte ``seed + round +
  chunk`` message fits one SHA-256 block.  Acceptance (``eff * 255 >=
  max_eb * random_byte``) is evaluated in PyTorch for ``K`` candidates per
  slot; the rare slot that exhausts all ``K`` reports ``found=False`` and
  stays on the scalar walk.
- :func:`_boundary_kernel` — the fused epoch boundary: the
  ``epoch_device._deltas_core`` pass, balance application,
  effective-balance hysteresis + registry-update masks (``_balance_core``),
  the next epoch's attester shuffling, and its per-slot proposer selection
  — ONE supervised, arbiter-slotted PyTorch program per leak mode, over the
  two kernels.  Committee slicing stays an O(1) host slice of the returned
  shuffling, per the ``shuffle_list``/``compute_shuffled_index`` invariant
  pinned in ``consensus/shuffling.py``.

On a CPU tensor the two kernels run their plain versions.  Shape
discipline matches ``ops/epoch_device.py``: power-of-two registry buckets
(:data:`N_BUCKETS`) with inert pad lanes — a pad lane never swaps
(``lane < n_live`` gate), is unreachable by the candidate walk (positions
stay below ``m_live``), and satisfies no registry-update mask.  The lane
axis of each op buckets against its own autotune vocabulary (``shuffle``,
``proposer_select``, ``epoch_boundary``).

**Mesh split** of the fused boundary (:func:`_boundary_sharded`, while the
device mesh is on; PyTorch has no partitioner, so each collective is
explicit): the registry pads to a multiple of the mesh size and splits
into row blocks (``device_mesh.ShardedEntry.place``).  The deltas' three
participating-balance sums are summed per shard, added on the first
member and sent back, then each shard finishes its rows (deltas, balance
application, hysteresis and masks).  The shuffle runs shard-local
swap-or-not rounds with an exchange a round: a round's partner lane can
sit in any shard, so each shard computes its own block of lanes from the
whole previous round (``shuffle_round`` at the block's offset), and the
blocks are gathered into the whole list on every member before the next
round (the gather waits on every shard's event of that round).  The
proposer walk reads ``new_eff`` at active positions across the registry:
the rows are gathered to the first member and the walk, per-slot work,
runs there.  The standalone :func:`shuffle_device` and
:func:`proposer_select_device` stay whole on the mesh's first device
(``epoch_device.op_device``).
"""

from __future__ import annotations

import inspect
import time
from collections import namedtuple
from dataclasses import dataclass
from hashlib import sha256
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import autotune
from . import cuda_epoch
from .devices import on_device, resolve_device, wait_for
from .epoch_device import (
    _PAD_ACTIVATION_EPOCH,
    _balance_core,
    _deltas_core,
    _participating_sums,
    fault_checks,
    grow_rows,
    mesh_rows,
    op_device,
    shard_sums,
)

#: Registry buckets — same ladder as the deltas pass (they dispatch over
#: the same registry axis and promote at the same sizes).
N_BUCKETS = (64, 256, 1024, 4096, 16384, 65536, 262144, 1048576)

#: Candidates examined per slot by the device proposer walk.  Acceptance
#: probability per candidate is >= 1/32 even for minimum-balance registries
#: (worst case eff/max_eb = 1/32), so 64 candidates leave a not-found
#: probability below (31/32)^64 ~= 13% worst-case and ~1e-9 at mainnet
#: balances; a not-found slot simply stays on the scalar spec walk.
PROPOSER_CANDIDATES = 64

#: Per-pad-row fills for the boundary's batched argument tuple (eff_bal,
#: activation, exit, withdrawable, slashed, prev_part, inactivity,
#: balance, act_elig, eb_cap, active_idx): rows that are never active,
#: never eligible, never queueable, and carry no balance.
_PAD_FILLS = (0, _PAD_ACTIVATION_EPOCH, 0, 0, False, 0, 0, 0, 0, 1, 0)


def _chunk_count(nb: int) -> int:
    """Digest chunks covering every lane of an ``nb``-lane bucket: pad
    lanes index the table at ``lane >> 3`` too (their swap is masked off,
    but the read must stay in bounds)."""
    return max(1, (nb + 255) // 256)


# --------------------------------------------------------------- programs


def _shuffle_core(arr, pivots, digests, n_live: int):
    """Apply the swap-or-not rounds of ``pivots``/``digests`` (row 0 first)
    to every lane of ``arr``; lanes at or past ``n_live`` never swap."""
    return cuda_epoch.shuffle_rounds(arr, pivots, digests, n_live)


def _shuffle_kernel(values, pivots, digests, n_live: int):
    """values: (nb,) int32; pivots: (R,) int32 (list order — decreasing
    round, host-reversed); digests: (R, chunks*32) uint8; n_live: int.
    Returns the shuffled (nb,) array; pad lanes pass through untouched."""
    return _shuffle_core(values, pivots, digests, n_live)


def _proposer_core(seed_words, pivots, rbytes, eff_act, m_live: int, max_eb: int):
    """The spec ``compute_proposer_index`` walk over (slot, candidate) lanes.

    seed_words: (S, 8) int32 — per-slot seed as big-endian SHA words;
    pivots: (S, R) int32 — per-slot round pivots (forward round order);
    rbytes: (S, K) int32 — the spec's acceptance random bytes;
    eff_act: (nb,) int64 — effective balance by *active-list position*;
    m_live: live active count; max_eb: the maximum effective balance.

    Returns ``(pos, found)``: per slot the accepted candidate's position in
    the active list (-1 when no candidate of the K accepted).
    """
    idx = cuda_epoch.proposer_walk(seed_words, pivots, rbytes.shape[1], m_live).to(torch.int64)
    accept = eff_act[idx] * 255 >= max_eb * rbytes.to(torch.int64)
    found = accept.any(dim=1)
    first = torch.argmax(accept.to(torch.int32), dim=1)
    pos = idx.gather(1, first[:, None])[:, 0]
    return torch.where(found, pos, -1), found


def _proposer_kernel(seed_words, pivots, rbytes, eff_act, m_live: int, max_eb: int):
    return _proposer_core(seed_words, pivots, rbytes, eff_act, m_live, max_eb)


def _boundary_kernel(
    eff_bal,            # (nb,) int64
    activation_epoch,   # (nb,) int64
    exit_epoch,         # (nb,) int64
    withdrawable_epoch, # (nb,) int64
    slashed,            # (nb,) bool
    prev_part,          # (nb,) int64
    inactivity,         # (nb,) int64
    balance,            # (nb,) int64 pre-boundary balances
    act_elig_epoch,     # (nb,) int64
    eb_cap,             # (nb,) int64 per-validator hysteresis cap
    active_idx,         # (nb,) int32 active-at-next-epoch validator indices
    sh_pivots,          # (R,) int32 attester-shuffle pivots (list order)
    sh_digests,         # (R, chunks*32) uint8
    seed_words,         # (S, 8) int32 per-slot proposer seeds
    prop_pivots,        # (S, R) int32 proposer pivots (forward order)
    rbytes,             # (S, K) int32
    previous_epoch, base_reward_per_increment, total_active_balance,
    increment, inactivity_score_bias, inactivity_score_recovery_rate,
    quotient, current_epoch, downward, upward, ejection_balance,
    far_future, finalized_epoch, max_eb, queue_lo, queue_hi,
    m_live,             # int live active count
    *,
    in_leak: bool,
):
    """The fused epoch boundary: deltas + balance application + hysteresis
    and registry masks + next-epoch shuffling + per-slot proposer walk,
    one program."""
    new_inactivity, balance_delta = _deltas_core(
        eff_bal, activation_epoch, exit_epoch, withdrawable_epoch, slashed,
        prev_part, inactivity, previous_epoch, base_reward_per_increment,
        total_active_balance, increment, inactivity_score_bias,
        inactivity_score_recovery_rate, quotient, in_leak=in_leak,
    )
    new_bal = (balance + balance_delta).clamp(min=0)
    new_eff, ejection_mask, queue_mask, activation_mask = _balance_core(
        new_bal, eff_bal, activation_epoch, exit_epoch, act_elig_epoch,
        eb_cap, current_epoch, increment, downward, upward,
        ejection_balance, far_future, finalized_epoch, queue_lo, queue_hi,
    )
    shuffled = _shuffle_core(active_idx, sh_pivots, sh_digests, m_live)
    # Proposer acceptance reads the POST-update effective balances — the
    # duty is looked up in the new epoch, after the transition applied.
    active = active_idx.to(torch.int64)
    eff_act = new_eff[active]
    pos, found = _proposer_core(seed_words, prop_pivots, rbytes, eff_act, m_live, max_eb)
    proposer = torch.where(found, active[pos.clamp(min=0)], -1)
    return (new_inactivity, balance_delta, new_eff, ejection_mask,
            queue_mask, activation_mask, shuffled, proposer, found)


#: The fused boundary's positional arguments by name (a shard's placed
#: tuple read as one).
_BoundaryArgs = namedtuple("_BoundaryArgs", [
    p.name for p in inspect.signature(_boundary_kernel).parameters.values()
    if p.kind is p.POSITIONAL_OR_KEYWORD])

#: The fused boundary's placement over the mesh (device_mesh.ShardedEntry;
#: lazy).
ENTRY_KEY = "lighthouse_tpu_torch/ops/shuffle_device.py:_boundary_kernel"
_SHARDED_ENTRY = None


def _sharded_entry():
    global _SHARDED_ENTRY
    if _SHARDED_ENTRY is None:
        from .. import device_mesh

        _SHARDED_ENTRY = device_mesh.ShardedEntry(ENTRY_KEY, _boundary_kernel)
    return _SHARDED_ENTRY


def _boundary_sums_shard(*args):
    """One member's raw participating sums over its row block."""
    a = _BoundaryArgs(*args)
    return _participating_sums(a.eff_bal, a.activation_epoch, a.exit_epoch, a.slashed,
                               a.prev_part, a.previous_epoch)


def _boundary_rows_shard(*args, in_leak: bool):
    """One member's rows of the boundary, with the combined sums (the
    last argument): deltas, balance application, hysteresis and the
    registry masks.  Returns ``_boundary_kernel``'s first six outputs for
    the block."""
    a = _BoundaryArgs(*args[:-1])
    new_inactivity, balance_delta = _deltas_core(
        a.eff_bal, a.activation_epoch, a.exit_epoch, a.withdrawable_epoch, a.slashed,
        a.prev_part, a.inactivity, a.previous_epoch, a.base_reward_per_increment,
        a.total_active_balance, a.increment, a.inactivity_score_bias,
        a.inactivity_score_recovery_rate, a.quotient, in_leak=in_leak,
        participating=args[-1])
    new_bal = (a.balance + balance_delta).clamp(min=0)
    return (new_inactivity, balance_delta) + _balance_core(
        new_bal, a.eff_bal, a.activation_epoch, a.exit_epoch, a.act_elig_epoch,
        a.eb_cap, a.current_epoch, a.increment, a.downward, a.upward,
        a.ejection_balance, a.far_future, a.finalized_epoch, a.queue_lo, a.queue_hi)


# Bytes the split shuffle's exchange moved: ``copied`` to the other
# members by ``device_mesh.replicate``, ``gathered`` by the round's
# ``torch.cat`` on the first member.  Bumped where each happens.
EXCHANGE_BYTES = {"copied": 0, "gathered": 0}


def reset_exchange_bytes() -> None:
    for key in EXCHANGE_BYTES:
        EXCHANGE_BYTES[key] = 0


def _shuffle_block_shard(values, pivots, digests, n_live: int, offset: int, count: int):
    """One member's block of one swap-or-not round over the whole list."""
    return cuda_epoch.shuffle_rounds(values, pivots, digests, n_live, offset, count)


def _boundary_sharded(placed: list, in_leak: bool) -> tuple:
    """``_boundary_kernel`` over the mesh, on ``place``'s per-shard
    arguments: the outputs on the first device, as the unsharded
    program's."""
    from .. import device_mesh

    entry = _sharded_entry()
    shards = [_BoundaryArgs(*p) for p in placed]
    sums = shard_sums(entry, placed, _boundary_sums_shard)
    rows = entry.run(lambda *a: _boundary_rows_shard(*a, in_leak=in_leak),
                     [p + (t,) for p, t in zip(placed, sums)])
    per_validator = tuple(torch.cat(out) for out in zip(*rows))
    # The shuffle: every member holds the whole list; a round's blocks are
    # gathered on the first member (run waits on each shard's event) and
    # sent to every member before the next round.
    first = shards[0]
    m_live = first.m_live
    active = torch.cat([a.active_idx.to(first.active_idx.device) for a in shards])
    blocks = entry.blocks(active.shape[0])
    whole = active
    for r in range(int(first.sh_pivots.shape[0])):
        members = device_mesh.replicate(whole)
        EXCHANGE_BYTES["copied"] += sum(x.nbytes for x in members if x is not whole)
        whole = torch.cat(entry.run(_shuffle_block_shard, [
            (x, a.sh_pivots[r:r + 1], a.sh_digests[r:r + 1], m_live, off, count)
            for x, a, (off, count) in zip(members, shards, blocks)]))
        EXCHANGE_BYTES["gathered"] += whole.nbytes
    # The proposer walk on the first member, over the gathered rows.
    active = active.to(torch.int64)
    new_eff = per_validator[2]
    pos, found = _proposer_core(first.seed_words, first.prop_pivots, first.rbytes,
                                new_eff[active], m_live, first.max_eb)
    proposer = torch.where(found, active[pos.clamp(min=0)], -1)
    return per_validator + (whole, proposer, found)


def _warmup_op(op: str):
    def warmup(nb: int) -> None:
        from .compile_cache import aot_warmup_op

        aot_warmup_op(op, nb)

    return warmup


# Self-tuning enrolment (autotune.py), one vocabulary per op; the fused
# boundary forks its program on in_leak, so its warmup covers both modes.
autotune.register_vocabulary(
    "shuffle", N_BUCKETS, telemetry_ops=("shuffle",), warmup=_warmup_op("shuffle"))
autotune.register_vocabulary(
    "proposer_select", N_BUCKETS, telemetry_ops=("proposer_select",),
    warmup=_warmup_op("proposer_select"))
autotune.register_vocabulary(
    "epoch_boundary", N_BUCKETS,
    telemetry_ops=("epoch_boundary", "epoch_boundary_leak"),
    warmup=_warmup_op("epoch_boundary"))


def _bucket(n: int, op: str = "shuffle") -> int:
    """The lane bucket for ``n`` rows of ``op`` (exact size past the top),
    against the live vocabulary (static :data:`N_BUCKETS` plus any
    controller-adopted overlay buckets)."""
    for b in autotune.bucket_vocabulary(op, N_BUCKETS):
        if n <= b:
            return b
    return n


# ------------------------------------------------- host-side table builds


def shuffle_tables(seed: bytes, rounds: int, n: int,
                   nb: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pivot/digest tables for a whole-LIST shuffle over ``n`` live lanes
    padded to ``nb``: rows are host-reversed into list application order
    (decreasing round first) so the kernel walks forward; chunks past the
    live range are zero (only pad lanes can index them, and their swap is
    masked off)."""
    from ..consensus.shuffling import round_digest_table

    chunks = _chunk_count(nb)
    pivots = np.zeros(rounds, dtype=np.int32)
    digests = np.zeros((rounds, chunks * 32), dtype=np.uint8)
    if n > 1 and rounds > 0:
        live_chunks = (n + 255) // 256
        p, d = round_digest_table(seed, rounds, live_chunks, n)
        pivots[:] = p[::-1].astype(np.int32)
        digests[:, : live_chunks * 32] = d[::-1]
    return pivots, digests


def proposer_tables(
    slot_seeds: Sequence[bytes], rounds: int, m: int,
    k: int = PROPOSER_CANDIDATES,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-slot seed words (big-endian SHA words as int32 bits, the form
    the walk takes), forward-order pivots, and acceptance random bytes for
    the device candidate walk (``m`` live active validators)."""
    s = len(slot_seeds)
    seed_words = np.zeros((s, 8), dtype=np.uint32)
    pivots = np.zeros((s, rounds), dtype=np.int32)
    rbytes = np.zeros((s, k), dtype=np.int32)
    m_mod = max(m, 1)
    for si, seed in enumerate(slot_seeds):
        seed_words[si] = np.frombuffer(seed, dtype=">u4")
        for r in range(rounds):
            pivots[si, r] = int.from_bytes(
                sha256(seed + bytes([r])).digest()[:8], "little") % m_mod
        for g in range((k + 31) // 32):
            block = np.frombuffer(
                sha256(seed + g.to_bytes(8, "little")).digest(),
                dtype=np.uint8,
            )
            take = min(32, k - g * 32)
            rbytes[si, g * 32:g * 32 + take] = block[:take]
    return seed_words.view(np.int32), pivots, rbytes


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _record(op: str, nb: int, n_live: int, dispatch_s: float, t_wait: float,
            compiled: bool, mesh: int = 0, shard_live=None) -> None:
    from .. import device_telemetry

    device_telemetry.record_batch(
        op=op,
        shape=(nb,),
        n_live=n_live,
        stages={"dispatch": dispatch_s, "wait": time.perf_counter() - t_wait},
        trace_id=device_telemetry.active_trace_id(),
        compiled=compiled,
        mesh=mesh,
        shard_live=shard_live,
    )


# ------------------------------------------------------------ dispatches


def shuffle_device(values, seed: bytes, rounds: int, device="cuda") -> np.ndarray:
    """Device ``shuffle_list`` on ``device`` (``"cpu"``: the kernel's plain
    version): numpy in, numpy out, bit-identical to the host path
    (``out[i] = values[compute_shuffled_index(i)]``)."""
    from .. import device_telemetry

    device = op_device(device, resolve_device)
    op = "shuffle"
    arr = np.asarray(values)
    n = int(arr.shape[0])
    if n <= 1 or rounds == 0:
        return arr.copy()
    nb = _bucket(n)
    fault_checks(op, nb)
    pivots, digests = shuffle_tables(seed, rounds, n, nb)
    padded = np.zeros(nb, dtype=np.int32)
    padded[:n] = arr.astype(np.int32)
    t_dispatch = time.perf_counter()
    with on_device(device):
        out = _shuffle_kernel(_upload(padded, device), _upload(pivots, device),
                              _upload(digests, device), n)
    dispatch_s = time.perf_counter() - t_dispatch
    compiled = device_telemetry.note_dispatch(op, (nb,), dispatch_s)
    t_wait = time.perf_counter()
    wait_for(device)
    shuffled = out[:n].cpu().numpy()
    _record(op, nb, n, dispatch_s, t_wait, compiled)
    return np.asarray(shuffled, dtype=arr.dtype)


def proposer_select_device(
    slot_seeds: Sequence[bytes],
    active_indices,
    effective_balance,
    *,
    rounds: int,
    max_effective_balance: int,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Device proposer selection on ``device`` for a batch of slot seeds
    over one active set.  ``effective_balance`` is indexed by VALIDATOR
    index (the registry array).  Returns ``(proposer, found)`` —
    ``proposer[s]`` is the spec's ``compute_proposer_index`` result
    whenever ``found[s]``; a not-found slot (all
    :data:`PROPOSER_CANDIDATES` rejected) stays on the scalar walk."""
    from .. import device_telemetry

    device = op_device(device, resolve_device)
    op = "proposer_select"
    active = np.asarray(active_indices, dtype=np.int64)
    m = int(active.shape[0])
    s = len(slot_seeds)
    if m == 0 or s == 0:
        return (np.full(s, -1, dtype=np.int64), np.zeros(s, dtype=bool))
    nb = _bucket(m, op)
    fault_checks(op, nb)
    seed_words, pivots, rbytes = proposer_tables(slot_seeds, rounds, m)
    eff = np.asarray(effective_balance, dtype=np.int64)
    eff_act = np.zeros(nb, dtype=np.int64)
    eff_act[:m] = eff[active]
    t_dispatch = time.perf_counter()
    with on_device(device):
        out = _proposer_kernel(
            _upload(seed_words, device), _upload(pivots, device),
            _upload(rbytes, device), _upload(eff_act, device), m,
            int(max_effective_balance))
    dispatch_s = time.perf_counter() - t_dispatch
    compiled = device_telemetry.note_dispatch(op, (nb,), dispatch_s)
    t_wait = time.perf_counter()
    wait_for(device)
    pos, found = (t.cpu().numpy() for t in out)
    _record(op, nb, m, dispatch_s, t_wait, compiled)
    pos = np.asarray(pos, dtype=np.int64)
    found = np.asarray(found, dtype=bool)
    proposer = np.where(found, active[np.maximum(pos, 0)], -1)
    return proposer, found


@dataclass
class BoundaryPlan:
    """Host-precomputed inputs for one fused epoch-boundary dispatch —
    built by ``per_epoch._build_boundary_plan`` from the state, consumed by
    both :func:`epoch_boundary_device` and the numpy golden."""

    # registry arrays, each (n,)
    effective_balance: np.ndarray
    activation_epoch: np.ndarray
    exit_epoch: np.ndarray
    withdrawable_epoch: np.ndarray
    slashed: np.ndarray
    prev_part: np.ndarray
    inactivity: np.ndarray
    balance: np.ndarray
    activation_eligibility_epoch: np.ndarray
    eb_cap: np.ndarray
    # active validator indices at the NEXT epoch, (m,)
    active_idx: np.ndarray
    # seeds for the next epoch's duties
    attester_seed: bytes
    slot_seeds: Tuple[bytes, ...]
    rounds: int
    # scalars
    previous_epoch: int
    base_reward_per_increment: int
    total_active_balance: int
    increment: int
    inactivity_score_bias: int
    inactivity_score_recovery_rate: int
    quotient: int
    current_epoch: int
    downward: int
    upward: int
    ejection_balance: int
    far_future: int
    finalized_epoch: int
    max_effective_balance: int
    queue_lo: int
    queue_hi: int

    @property
    def n(self) -> int:
        return int(self.effective_balance.shape[0])

    @property
    def m(self) -> int:
        return int(self.active_idx.shape[0])


def boundary_arrays(plan: BoundaryPlan, nb: int) -> tuple:
    """``_boundary_kernel``'s positional arguments for ``plan`` as host
    values: the 11 batched arrays padded to ``nb`` rows, the 5 tables, the
    16 scalars and ``m_live``."""
    n, m = plan.n, plan.m
    sh_pivots, sh_digests = shuffle_tables(plan.attester_seed, plan.rounds, m, nb)
    seed_words, prop_pivots, rbytes = proposer_tables(plan.slot_seeds, plan.rounds, m)
    active_padded = np.zeros(nb, dtype=np.int32)
    active_padded[:m] = plan.active_idx.astype(np.int32)
    batched = (
        np.asarray(plan.effective_balance, dtype=np.int64),
        np.asarray(plan.activation_epoch, dtype=np.int64),
        np.asarray(plan.exit_epoch, dtype=np.int64),
        np.asarray(plan.withdrawable_epoch, dtype=np.int64),
        np.asarray(plan.slashed, dtype=bool),
        np.asarray(plan.prev_part, dtype=np.int64),
        np.asarray(plan.inactivity, dtype=np.int64),
        np.asarray(plan.balance, dtype=np.int64),
        np.asarray(plan.activation_eligibility_epoch, dtype=np.int64),
        np.asarray(plan.eb_cap, dtype=np.int64),
    )
    if nb != n:
        batched = tuple(grow_rows(a, nb, f) for a, f in zip(batched, _PAD_FILLS))
    batched = batched + (active_padded,)
    tables = (sh_pivots, sh_digests, seed_words, prop_pivots, rbytes)
    scalars = (
        plan.previous_epoch, plan.base_reward_per_increment,
        plan.total_active_balance, plan.increment,
        plan.inactivity_score_bias,
        plan.inactivity_score_recovery_rate, plan.quotient,
        plan.current_epoch, plan.downward, plan.upward,
        plan.ejection_balance, plan.far_future, plan.finalized_epoch,
        plan.max_effective_balance, plan.queue_lo, plan.queue_hi,
    )
    return (*batched, *tables, *(int(s) for s in scalars), m)


def boundary_inputs(plan: BoundaryPlan, device: torch.device) -> tuple:
    """``_boundary_kernel``'s positional arguments for ``plan`` on
    ``device``, padded to the registry bucket; and the bucket."""
    nb = _bucket(plan.n, "epoch_boundary")
    host = boundary_arrays(plan, nb)
    return (*(_upload(a, device) for a in host[:16]), *host[16:]), nb


def epoch_boundary_device(plan: BoundaryPlan, *, in_leak: bool, device="cuda"):
    """numpy in, numpy out — ONE device program on ``device`` for the whole
    epoch boundary.  Returns ``(new_inactivity, balance_delta, new_eff,
    ejection_mask, queue_mask, activation_mask, shuffling, proposer,
    found)``; per-validator arrays sliced to ``plan.n``, the shuffling to
    ``plan.m``, proposer/found per slot.  While the device mesh is on the
    program splits over its members (:func:`_boundary_sharded`), with the
    same outputs."""
    from .. import device_telemetry

    op = "epoch_boundary_leak" if in_leak else "epoch_boundary"
    n, m = plan.n, plan.m
    mesh, nb = mesh_rows(_bucket(n, "epoch_boundary"))
    fault_checks(op, nb, mesh)
    if mesh:
        placed = _sharded_entry().place(*boundary_arrays(plan, nb))
        t_dispatch = time.perf_counter()
        out = _boundary_sharded(placed, bool(in_leak))
        device = out[0].device
    else:
        device = resolve_device(device)
        args, nb = boundary_inputs(plan, device)
        t_dispatch = time.perf_counter()
        with on_device(device):
            out = _boundary_kernel(*args, in_leak=bool(in_leak))
    dispatch_s = time.perf_counter() - t_dispatch
    compiled = device_telemetry.note_dispatch(op, (nb,), dispatch_s, mesh=mesh)
    t_wait = time.perf_counter()
    wait_for(device)
    (new_inactivity, balance_delta, new_eff, ejection_mask, queue_mask,
     activation_mask, shuffled, proposer, found) = (t.cpu().numpy() for t in out)
    _record(op, nb, n, dispatch_s, t_wait, compiled, mesh=mesh,
            shard_live=_sharded_entry().shard_live_counts(n, nb) if mesh else None)
    return (
        np.asarray(new_inactivity[:n], dtype=np.int64),
        np.asarray(balance_delta[:n], dtype=np.int64),
        np.asarray(new_eff[:n], dtype=np.int64),
        np.asarray(ejection_mask[:n], dtype=bool),
        np.asarray(queue_mask[:n], dtype=bool),
        np.asarray(activation_mask[:n], dtype=bool),
        np.asarray(shuffled[:m], dtype=np.int64),
        np.asarray(proposer, dtype=np.int64),
        np.asarray(found, dtype=bool),
    )
