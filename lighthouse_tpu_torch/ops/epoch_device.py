"""Epoch-processing deltas on the card: the fused per-validator pass.

The port of ``lighthouse_tpu/ops/epoch_device.py``.  The altair+ epoch
transition's per-validator math — inactivity-score updates,
participation-flag rewards, penalties, inactivity penalties — as one
elementwise PyTorch program over the ``EpochArrays`` contract
(``consensus/per_epoch.py``): the analog of the reference's
``single_pass.rs`` fused epoch loop.  At 2^20 validators the pass is
memory-bound vector arithmetic that torch has a CUDA op for at every step
(``where``, ``minimum``, floor division and sums on int64), so it has no
hand-written kernel.

Epoch math needs 64-bit integers (effective balances are ~3.2e10 gwei and
reward intermediates reach ~1e13): every tensor is int64 (``bool`` for
masks), and every division floors (``torch.div(..., rounding_mode=
"floor")``), as ``jnp``'s ``//`` does.

Shape discipline: registries dispatch at the JAX package's power-of-two
**registry buckets** (:data:`N_BUCKETS`, through 2^20 validators), padded
with never-active rows (far-future activation epoch, zero balance) that
are ineligible for every flag mask and therefore contribute exactly zero
to the registry-wide participating-increment sums.

Semantics are bit-identical to the numpy path and to the JAX program (same
floor divisions, same masks; ``tests/test_torch_epoch.py``).  The
registry axis buckets against ``autotune.bucket_vocabulary(
"epoch_deltas", N_BUCKETS)``.

**Mesh split** (``device_mesh.ShardedEntry``, while the mesh is on): the
registry pads to a multiple of the mesh size and splits into row blocks.
The only registry-wide terms are the three participating-balance sums, so
each shard first sums its rows (:func:`_participating_sums`), the raw sums
are added on the first member and sent back, and each shard finishes its
own rows (:func:`_deltas_core` with the combined sums).  The floor
division by the increment applies to the combined raw sum: a sum of
per-shard floors would differ.  PyTorch has no partitioner to insert that
collective, so the combine is explicit, as the verify's is.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..types.spec import (
    PARTICIPATION_FLAG_WEIGHTS,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
)
from .. import autotune
from .devices import on_device, resolve_device, wait_for


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _deltas_core(
    eff_bal,            # (n,) int64 gwei
    activation_epoch,   # (n,) int64
    exit_epoch,         # (n,) int64
    withdrawable_epoch, # (n,) int64
    slashed,            # (n,) bool
    prev_part,          # (n,) int64 flag bits
    inactivity,         # (n,) int64
    previous_epoch,     # int
    base_reward_per_increment,  # int
    total_active_balance,       # int
    increment,          # int
    inactivity_score_bias,      # int
    inactivity_score_recovery_rate,  # int
    quotient,           # int
    *,
    in_leak: bool,
    participating=None,  # (3,) int64 registry-wide raw sums, or None
):
    """Body of the deltas pass — shared between the standalone
    :func:`_deltas_kernel` entry and the fused epoch-boundary program
    (``ops/shuffle_device.py:_boundary_kernel``).  Returns
    ``(new_inactivity, balance_delta)``.  ``participating`` holds the
    registry-wide participating-balance sums where these rows are one
    shard of it (:func:`_participating_sums`, combined); None sums these
    rows."""
    active_prev = (activation_epoch <= previous_epoch) & (previous_epoch < exit_epoch)
    eligible = active_prev | (slashed & (previous_epoch + 1 < withdrawable_epoch))

    def flag_mask(flag_index):
        return _flag_mask(prev_part, active_prev, slashed, flag_index)

    prev_target = flag_mask(TIMELY_TARGET_FLAG_INDEX)

    # --- inactivity updates (spec process_inactivity_updates)
    delta = torch.where(prev_target, -inactivity.clamp(max=1), inactivity_score_bias)
    new_inactivity = inactivity + torch.where(eligible, delta, 0)
    if not in_leak:
        new_inactivity = new_inactivity - torch.where(
            eligible, new_inactivity.clamp(max=inactivity_score_recovery_rate), 0)

    # --- rewards and penalties (spec process_rewards_and_penalties)
    base_reward = _floor_div(eff_bal, increment) * base_reward_per_increment
    active_increments = total_active_balance // increment
    rewards = torch.zeros_like(eff_bal)
    penalties = torch.zeros_like(eff_bal)
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        participating_mask = flag_mask(flag_index)
        raw = (torch.where(participating_mask, eff_bal, 0).sum() if participating is None
               else participating[flag_index])
        participating_increments = _floor_div(raw, increment)
        if not in_leak:
            flag_rewards = _floor_div(
                base_reward * weight * participating_increments,
                active_increments * WEIGHT_DENOMINATOR)
            rewards = rewards + torch.where(eligible & participating_mask, flag_rewards, 0)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties = penalties + torch.where(
                eligible & ~participating_mask,
                _floor_div(base_reward * weight, WEIGHT_DENOMINATOR), 0)
    inactivity_penalty = _floor_div(eff_bal * new_inactivity, inactivity_score_bias * quotient)
    penalties = penalties + torch.where(eligible & ~prev_target, inactivity_penalty, 0)
    return new_inactivity, rewards - penalties


def _flag_mask(prev_part, active_prev, slashed, flag_index: int):
    return (((prev_part >> flag_index) & 1) == 1) & active_prev & ~slashed


def _participating_sums(eff_bal, activation_epoch, exit_epoch, slashed, prev_part,
                        previous_epoch):
    """(3,) int64: the raw sum of ``eff_bal`` over each flag's
    participating rows — a shard's part of the registry-wide sums
    (exact: int64 sums of at most 2^20 balances of ~3.2e10 gwei)."""
    active_prev = (activation_epoch <= previous_epoch) & (previous_epoch < exit_epoch)
    return torch.stack([
        torch.where(_flag_mask(prev_part, active_prev, slashed, f), eff_bal, 0).sum()
        for f in range(len(PARTICIPATION_FLAG_WEIGHTS))])


def _deltas_kernel(
    eff_bal, activation_epoch, exit_epoch, withdrawable_epoch, slashed,
    prev_part, inactivity, previous_epoch, base_reward_per_increment,
    total_active_balance, increment, inactivity_score_bias,
    inactivity_score_recovery_rate, quotient, *, in_leak: bool,
):
    """The deltas program (the JAX package's jitted ``_deltas_kernel``):
    plain PyTorch on the tensors' device."""
    return _deltas_core(
        eff_bal, activation_epoch, exit_epoch, withdrawable_epoch, slashed,
        prev_part, inactivity, previous_epoch, base_reward_per_increment,
        total_active_balance, increment, inactivity_score_bias,
        inactivity_score_recovery_rate, quotient, in_leak=in_leak,
    )


def _balance_core(
    balance,            # (n,) int64 post-delta balances
    eff_bal,            # (n,) int64 current effective balances
    activation_epoch,   # (n,) int64
    exit_epoch,         # (n,) int64
    act_elig_epoch,     # (n,) int64 activation_eligibility_epoch
    eb_cap,             # (n,) int64 per-validator effective-balance cap
    current_epoch,      # int
    increment,          # int
    downward,           # int hysteresis downward threshold
    upward,             # int hysteresis upward threshold
    ejection_balance,   # int
    far_future,         # int FAR_FUTURE_EPOCH (clamped to int64)
    finalized_epoch,    # int
    queue_lo,           # int activation-queue eligibility low bound
    queue_hi,           # int activation-queue eligibility high bound
):
    """Effective-balance hysteresis + registry-update masks, the device
    half of ``per_epoch._process_effective_balance_updates`` /
    ``_process_registry_updates``.  Bucket-pad rows (zero balances,
    activation epoch ``_PAD_ACTIVATION_EPOCH``, eligibility epoch 0,
    cap 1) satisfy none of the masks and keep a zero effective balance.

    Returns ``(new_eff, ejection_mask, queue_mask, activation_mask)``.
    """
    needs = (balance + downward < eff_bal) | (eff_bal + upward < balance)
    new_eff = torch.where(
        needs,
        torch.minimum(balance - torch.remainder(balance, increment), eb_cap),
        eff_bal,
    )
    active_cur = (activation_epoch <= current_epoch) & (current_epoch < exit_epoch)
    ejection_mask = active_cur & (eff_bal <= ejection_balance)
    queue_mask = (
        (act_elig_epoch == far_future)
        & (eff_bal >= queue_lo)
        & (eff_bal <= queue_hi)
    )
    activation_mask = (act_elig_epoch <= finalized_epoch) & (activation_epoch == far_future)
    return new_eff, ejection_mask, queue_mask, activation_mask


#: Epoch far beyond any reachable epoch: bucket-pad rows use it as their
#: activation epoch so they are never active/eligible and contribute
#: exactly zero to every registry-wide sum.
_PAD_ACTIVATION_EPOCH = 1 << 62

#: Power-of-two registry buckets through 2^20 validators (the JAX
#: package's).  A registry past the top bucket dispatches at its exact
#: size.
N_BUCKETS = (64, 256, 1024, 4096, 16384, 65536, 262144, 1048576)

#: Per-pad-row fill values for the batched argument tuple (eff_bal,
#: activation, exit, withdrawable, slashed, prev_part, inactivity): a row
#: that is never active, never eligible, carries no balance and no flags.
_PAD_FILLS = (0, _PAD_ACTIVATION_EPOCH, 0, 0, False, 0, 0)


def _warmup(nb: int) -> None:
    from .compile_cache import aot_warmup_op

    aot_warmup_op("epoch_deltas", nb)


# Self-tuning enrolment (autotune.py): the registry vocabulary is ratio-4
# past the 64 bucket, so a network parked between buckets can earn a
# midpoint registry bucket; the warmup dispatches both leak modes.
autotune.register_vocabulary(
    "epoch_deltas", N_BUCKETS,
    telemetry_ops=("epoch_deltas", "epoch_deltas_leak"), warmup=_warmup)


def _bucket(n: int, vocabulary: str = "epoch_deltas") -> int:
    """The registry bucket for ``n`` validators (exact size past the top),
    against the live vocabulary (static :data:`N_BUCKETS` plus any
    controller-adopted overlay buckets)."""
    for b in autotune.bucket_vocabulary(vocabulary, N_BUCKETS):
        if n <= b:
            return b
    return n


def op_device(device, resolve=None) -> torch.device:
    """``device`` resolved (by ``resolve``, default ``resolve_device``) —
    or, while the device mesh is on, the mesh's first device: the
    standalone shuffle and proposer programs gather across the whole list
    and run whole on one member (the deltas and the fused boundary split
    over the mesh instead)."""
    from .. import device_mesh

    dev = (resolve or resolve_device)(device)
    if device_mesh.enabled():
        return device_mesh.first_device()
    return dev


def grow_rows(a: np.ndarray, rows: int, fill) -> np.ndarray:
    """``a`` padded with ``fill`` rows to ``rows`` rows."""
    out = np.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def fault_checks(op: str, nb: int, mesh: int = 0) -> None:
    """The fault-injection points of a device dispatch of ``op`` at
    ``nb`` rows (over ``mesh`` members, 0 unsharded): ``device.compile``
    before its first dispatch, then ``device.dispatch``."""
    from .. import device_telemetry, fault_injection

    if fault_injection.ACTIVE:
        if not device_telemetry.COMPILE_CACHE.seen(op, (nb,), mesh=mesh):
            fault_injection.check("device.compile", op=op)
        fault_injection.check("device.dispatch", op=op)


def mesh_rows(nb: int) -> tuple:
    """``(mesh size, rows)`` of a dispatch at bucket ``nb``: (0, nb) while
    the mesh is off, else the live members and ``nb`` padded to a
    multiple of them."""
    from .. import device_mesh

    if not device_mesh.enabled():
        return 0, nb
    return device_mesh.size(), device_mesh.pad_rows(nb)


def shard_sums(entry, placed: list, sums_fn) -> list:
    """The registry-wide participating sums of a sharded dispatch on every
    member, in shard order: each shard's raw sums (``sums_fn`` over its
    placed arguments) added on the first member, then sent to each."""
    from .. import device_mesh

    return device_mesh.replicate(torch.stack(entry.run(sums_fn, placed)).sum(dim=0))


#: The deltas' placement over the mesh (device_mesh.ShardedEntry; lazy).
ENTRY_KEY = "lighthouse_tpu_torch/ops/epoch_device.py:_deltas_kernel"
_SHARDED_ENTRY = None


def _sharded_entry():
    global _SHARDED_ENTRY
    if _SHARDED_ENTRY is None:
        from .. import device_mesh

        _SHARDED_ENTRY = device_mesh.ShardedEntry(ENTRY_KEY, _deltas_kernel)
    return _SHARDED_ENTRY


def _deltas_sums_shard(eff_bal, activation_epoch, exit_epoch, withdrawable_epoch, slashed,
                       prev_part, inactivity, previous_epoch, *scalars):
    """One member's raw participating sums over its row block."""
    return _participating_sums(eff_bal, activation_epoch, exit_epoch, slashed, prev_part,
                               previous_epoch)


def _deltas_sharded(placed: list, in_leak: bool):
    """The deltas over the mesh: per-shard sums, combined on the first
    member and sent back, then each shard's rows.  Returns the outputs on
    the first device, rows in order."""
    entry = _sharded_entry()
    sums = shard_sums(entry, placed, _deltas_sums_shard)
    parts = entry.run(
        lambda *a: _deltas_core(*a[:-1], in_leak=in_leak, participating=a[-1]),
        [p + (t,) for p, t in zip(placed, sums)])
    return tuple(torch.cat(rows) for rows in zip(*parts))


def epoch_deltas_device(
    arrays,
    prev_part: np.ndarray,
    inactivity: np.ndarray,
    *,
    previous_epoch: int,
    in_leak: bool,
    base_reward_per_increment: int,
    total_active_balance: int,
    quotient: int,
    spec,
    device="cuda",
):
    """numpy in, numpy out — the device analog of the per_epoch numpy block,
    on ``device`` (``"cuda"``; ``"cpu"`` runs the same program on the CPU).
    Returns ``(new_inactivity, balance_delta)`` (int64 arrays).

    The registry pads to its power-of-two bucket (:data:`N_BUCKETS`) with
    never-active rows (far-future activation: ineligible for every flag
    mask, so the participating-increment sums are untouched) — mesh on,
    further to a multiple of the mesh size, split over the members — and
    the pad rows are sliced back off the outputs."""
    from .. import device_telemetry

    op = "epoch_deltas_leak" if in_leak else "epoch_deltas"
    n = int(np.asarray(arrays.effective_balance).shape[0])
    mesh, nb = mesh_rows(_bucket(n))
    device = None if mesh else resolve_device(device)
    fault_checks(op, nb, mesh)
    batched = (
        np.asarray(arrays.effective_balance, dtype=np.int64),
        np.asarray(arrays.activation_epoch, dtype=np.int64),
        np.asarray(arrays.exit_epoch, dtype=np.int64),
        np.asarray(arrays.withdrawable_epoch, dtype=np.int64),
        np.asarray(arrays.slashed, dtype=bool),
        np.asarray(prev_part, dtype=np.int64),
        np.asarray(inactivity, dtype=np.int64),
    )
    scalars = (
        int(previous_epoch), int(base_reward_per_increment), int(total_active_balance),
        int(spec.effective_balance_increment), int(spec.inactivity_score_bias),
        int(spec.inactivity_score_recovery_rate), int(quotient),
    )
    if nb != n:
        batched = tuple(grow_rows(a, nb, f) for a, f in zip(batched, _PAD_FILLS))
    t_dispatch = time.perf_counter()
    if mesh:
        entry = _sharded_entry()
        out = _deltas_sharded(entry.place(*batched, *scalars), bool(in_leak))
        device = out[0].device
    else:
        with on_device(device):
            out = _deltas_kernel(
                *(torch.from_numpy(a).to(device) for a in batched), *scalars,
                in_leak=bool(in_leak))
    dispatch_s = time.perf_counter() - t_dispatch
    compiled = device_telemetry.note_dispatch(op, (nb,), dispatch_s, mesh=mesh)
    t_wait = time.perf_counter()
    wait_for(device)
    new_inactivity, balance_delta = (t[:n].cpu().numpy() for t in out)
    device_telemetry.record_batch(
        op=op,
        shape=(nb,),
        n_live=n,
        stages={"dispatch": dispatch_s, "wait": time.perf_counter() - t_wait},
        trace_id=device_telemetry.active_trace_id(),
        compiled=compiled,
        mesh=mesh,
        shard_live=_sharded_entry().shard_live_counts(n, nb) if mesh else None,
    )
    return (np.asarray(new_inactivity, dtype=np.int64),
            np.asarray(balance_delta, dtype=np.int64))
