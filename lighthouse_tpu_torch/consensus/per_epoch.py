"""Epoch processing (reference: ``consensus/state_processing/src/per_epoch_processing``).

The altair+ path is array-first — the analog of the reference's fused
``single_pass.rs`` epoch loop: validator registry fields, balances,
participation flags and inactivity scores are pulled into dense int64 numpy
arrays once, every per-validator rule becomes fused vector arithmetic, and
results are written back in one pass.

A copy of the JAX package's ``lighthouse_tpu/consensus/per_epoch.py``.  One
default differs on purpose: the port's epoch path runs on the card.  The
``"device"`` backend, the fused boundary and device ``"cuda"`` are on until
:func:`configure` picks the ``"numpy"`` backend or ``device="cpu"`` (the
CUDA kernels' plain versions); asking for the card where there is none
raises.  On the card a failed, hung or breaker-refused epoch job raises into
the caller; the exact numpy composites answer failures only for
``device="cpu"``.  The JAX package defaults to ``"numpy"``.

The phase0 path replays pending attestations (matching source/target/head) as
the spec requires; it shares the justification engine with altair+.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..types.spec import (
    GENESIS_EPOCH,
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
    ChainSpec,
    FAR_FUTURE_EPOCH,
)
from . import helpers as h
from . import safe_arith as sa
from .safe_arith import ArithError

BASE_REWARDS_PER_EPOCH = 4  # phase0

_I64_MAX = np.iinfo(np.int64).max


# ----------------------------------------------------------- array extract


class EpochArrays:
    """Dense snapshot of the registry for one epoch-processing run."""

    def __init__(self, state, spec: ChainSpec):
        vs = state.validators
        n = len(vs)
        self.n = n
        self.effective_balance = np.fromiter(
            (v.effective_balance for v in vs), dtype=np.int64, count=n
        )
        self.activation_epoch = np.fromiter(
            (min(v.activation_epoch, 2**63 - 1) for v in vs), dtype=np.int64, count=n
        )
        self.exit_epoch = np.fromiter(
            (min(v.exit_epoch, 2**63 - 1) for v in vs), dtype=np.int64, count=n
        )
        self.withdrawable_epoch = np.fromiter(
            (min(v.withdrawable_epoch, 2**63 - 1) for v in vs), dtype=np.int64, count=n
        )
        self.activation_eligibility_epoch = np.fromiter(
            (min(v.activation_eligibility_epoch, 2**63 - 1) for v in vs),
            dtype=np.int64, count=n,
        )
        self.slashed = np.fromiter((v.slashed for v in vs), dtype=bool, count=n)

    def active_mask(self, epoch: int) -> np.ndarray:
        return (self.activation_epoch <= epoch) & (epoch < self.exit_epoch)

    def eligible_mask(self, prev_epoch: int) -> np.ndarray:
        """Spec ``get_eligible_validator_indices``."""
        return self.active_mask(prev_epoch) | (
            self.slashed & (prev_epoch + 1 < self.withdrawable_epoch)
        )


def _participation_array(lst, n: int) -> np.ndarray:
    return np.fromiter(lst, dtype=np.int64, count=n)


def _balances_array(state, n: int) -> np.ndarray:
    """Balances as an int64 array.  A u64 balance past 2**63-1 is legal for
    the spec but unrepresentable on the int64 device path — surface that as
    a typed ArithError instead of numpy's bare OverflowError.

    Known, deliberate divergence: the reference (u64 throughout) would
    process such a state; this build's epoch vector contract is int64, so
    it rejects it typed instead.  2**63 gwei is ~70x all ETH in existence —
    reachable only on adversarial custom networks, where a loud typed error
    beats a silent wrong answer."""
    try:
        return np.fromiter(state.balances, dtype=np.int64, count=n)
    except OverflowError as e:
        raise ArithError(f"balance exceeds int64 device range: {e}") from e


# ------------------------------------------------- justification (shared)


def compute_justification_and_finalization(
    *,
    bits,
    old_previous_justified,  # (epoch, root)
    old_current_justified,  # (epoch, root)
    previous_epoch: int,
    current_epoch: int,
    previous_boundary_root: bytes,
    current_boundary_root: bytes,
    total_active_balance: int,
    previous_target_balance: int,
    current_target_balance: int,
):
    """Pure spec ``weigh_justification_and_finalization`` →
    ``(new_bits, new_justified | None, new_finalized | None)``.

    Single source of truth for the 4-rule finalization table; used by both the
    mutating epoch transition below and fork choice's unrealized-checkpoint
    ("pull-up") computation, which must never drift apart.

    Boundary roots may be bytes or zero-arg callables: a state sitting exactly
    on the current epoch's start slot has no current-boundary root yet
    (``get_block_root`` requires ``slot < state.slot``), but then the current
    target balance is necessarily below the 2/3 threshold (participation was
    just rotated), so a lazy root is simply never evaluated."""
    bits = [False] + list(bits)[:-1]
    justified = None
    if sa.safe_mul(previous_target_balance, 3) >= sa.safe_mul(total_active_balance, 2):
        root = previous_boundary_root() if callable(previous_boundary_root) else previous_boundary_root
        justified = (previous_epoch, root)
        bits[1] = True
    if sa.safe_mul(current_target_balance, 3) >= sa.safe_mul(total_active_balance, 2):
        root = current_boundary_root() if callable(current_boundary_root) else current_boundary_root
        justified = (current_epoch, root)
        bits[0] = True

    # Finalization: 2nd/3rd/4th most recent epochs justified as source.
    finalized = None
    if all(bits[1:4]) and old_previous_justified[0] + 3 == current_epoch:
        finalized = old_previous_justified
    if all(bits[1:3]) and old_previous_justified[0] + 2 == current_epoch:
        finalized = old_previous_justified
    if all(bits[0:3]) and old_current_justified[0] + 2 == current_epoch:
        finalized = old_current_justified
    if all(bits[0:2]) and old_current_justified[0] + 1 == current_epoch:
        finalized = old_current_justified
    return bits, justified, finalized


def weigh_justification_and_finalization(
    state, total_active_balance: int, previous_target_balance: int, current_target_balance: int,
    spec: ChainSpec,
) -> None:
    previous_epoch = h.get_previous_epoch(state, spec)
    current_epoch = h.get_current_epoch(state, spec)
    types_cp = type(state.current_justified_checkpoint)

    bits, justified, finalized = compute_justification_and_finalization(
        bits=state.justification_bits,
        old_previous_justified=(
            int(state.previous_justified_checkpoint.epoch),
            bytes(state.previous_justified_checkpoint.root),
        ),
        old_current_justified=(
            int(state.current_justified_checkpoint.epoch),
            bytes(state.current_justified_checkpoint.root),
        ),
        previous_epoch=previous_epoch,
        current_epoch=current_epoch,
        previous_boundary_root=h.get_block_root(state, previous_epoch, spec),
        current_boundary_root=h.get_block_root(state, current_epoch, spec),
        total_active_balance=total_active_balance,
        previous_target_balance=previous_target_balance,
        current_target_balance=current_target_balance,
    )
    state.previous_justified_checkpoint = state.current_justified_checkpoint
    state.justification_bits = bits
    if justified is not None:
        state.current_justified_checkpoint = types_cp(epoch=justified[0], root=justified[1])
    if finalized is not None:
        state.finalized_checkpoint = types_cp(epoch=finalized[0], root=finalized[1])


def is_in_inactivity_leak(state, spec: ChainSpec) -> bool:
    return (
        h.get_previous_epoch(state, spec) - state.finalized_checkpoint.epoch
        > spec.min_epochs_to_inactivity_penalty
    )


# ------------------------------------------------------------ altair path


def _epoch_deltas_numpy(
    arrays: "EpochArrays",
    prev_part: np.ndarray,
    inactivity: np.ndarray,
    *,
    previous_epoch: int,
    in_leak: bool,
    base_reward_per_increment: int,
    total_active_balance: int,
    quotient: int,
    spec: ChainSpec,
):
    """The fused per-validator epoch pass (inactivity updates + flag
    rewards + penalties) on numpy.  Returns (new_inactivity,
    balance_delta); bit-identical to the device variant in
    ops/epoch_device.py (tests assert equality)."""
    n = arrays.n
    eligible = arrays.eligible_mask(previous_epoch)
    prev_target = _unslashed_participating_mask(
        arrays, prev_part, TIMELY_TARGET_FLAG_INDEX, previous_epoch
    )

    delta = np.where(prev_target, -np.minimum(1, inactivity), spec.inactivity_score_bias)
    new_inactivity = inactivity + np.where(eligible, delta, 0)
    if not in_leak:
        new_inactivity = new_inactivity - np.where(
            eligible,
            np.minimum(spec.inactivity_score_recovery_rate, new_inactivity),
            0,
        )

    increment = spec.effective_balance_increment
    # safe-arith: ok(int64 vector: eb/increment <= 2048, brpi <= increment)
    base_reward = (arrays.effective_balance // increment) * base_reward_per_increment
    active_increments = total_active_balance // increment
    rewards = np.zeros(n, dtype=np.int64)
    penalties = np.zeros(n, dtype=np.int64)
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        participating = _unslashed_participating_mask(
            arrays, prev_part, flag_index, previous_epoch
        )
        participating_increments = int(
            arrays.effective_balance[participating].sum()
        ) // increment
        if not in_leak:
            flag_rewards = (
                # safe-arith: ok(int64 vector: reward < base_reward <= eb)
                base_reward * weight * participating_increments
                // (active_increments * WEIGHT_DENOMINATOR)
            )
            # safe-arith: ok(int64 vector accumulate, bounded by 4*base_reward)
            rewards += np.where(eligible & participating, flag_rewards, 0)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties += np.where(  # safe-arith: ok(int64 vector accumulate)
                # safe-arith: ok(int64 vector: weight <= 64, base_reward bounded)
                eligible & ~participating, base_reward * weight // WEIGHT_DENOMINATOR, 0
            )
    # Inactivity scores grow without bound during a leak; eb * score can
    # silently wrap int64 (~2.9e8 score at 32-ETH eb).  Past that bound,
    # compute the penalty term exactly in Python ints.  Clamp to 2**62, NOT
    # _I64_MAX: the clamped value still dwarfs any real balance (so the
    # validator drains to zero through the max(0, ...) floor downstream),
    # while leaving headroom so the `penalties +=` accumulation and the
    # `rewards - penalties` combine below cannot themselves wrap int64.
    max_eb = int(arrays.effective_balance.max()) if n else 0
    max_inact = int(new_inactivity.max()) if n else 0
    denom = spec.inactivity_score_bias * quotient
    if max_eb and max_inact and max_eb * max_inact > _I64_MAX:
        inactivity_penalty = np.fromiter(
            (
                min(int(e) * int(s) // denom, 2**62)
                for e, s in zip(arrays.effective_balance, new_inactivity)
            ),
            dtype=np.int64,
            count=n,
        )
    else:
        inactivity_penalty = (
            arrays.effective_balance * new_inactivity // denom
        )  # safe-arith: ok(int64 vector path, overflow-guarded above)
    # safe-arith: ok(int64 vector accumulate + combine, terms bounded above)
    penalties += np.where(eligible & ~prev_target, inactivity_penalty, 0)
    return new_inactivity, rewards - penalties  # safe-arith: ok(int64 vector combine)


_EPOCH_BACKEND = "device"

#: The device the epoch programs run on: ``"cuda"`` (the CUDA kernels) or
#: ``"cpu"`` (their plain PyTorch versions, the CPU tests' choice).
_DEVICE = "cuda"


def set_epoch_backend(name: str) -> None:
    """'numpy' (host, hermetic) or 'device' (the PyTorch programs in
    ops/epoch_device.py and ops/shuffle_device.py)."""
    global _EPOCH_BACKEND
    if name not in ("numpy", "device"):
        raise ValueError(f"unknown epoch backend {name!r}")
    _EPOCH_BACKEND = name


def configure(backend=None, fused_boundary=None, device=None) -> None:
    """Re-tune the epoch path (tests / the caller that assembles a node):
    ``backend`` ``"numpy"`` or ``"device"``, the fused boundary on or off,
    and the device the programs run on (``"cuda"`` by default, ``"cpu"``
    for the kernels' plain versions)."""
    global _DEVICE
    if backend is not None:
        set_epoch_backend(backend)
    if fused_boundary is not None:
        set_fused_boundary(fused_boundary)
    if device is not None:
        _DEVICE = str(device)


def reset_for_tests() -> None:
    """Back to the defaults: the device backend, fused, on the card."""
    configure(backend="device", fused_boundary=True, device="cuda")


def _device():
    """The configured device as a torch.device; raises where it names a
    card this machine does not have."""
    from ..ops.devices import resolve_device

    return resolve_device(_DEVICE)


def _supervised(op: str, device_fn, host_fn, device):
    """One supervised epoch job, pipeline-routed when the job pipeline runs
    on ``device``: on the card a failure raises (``host_on_failure=False``),
    on the CPU the numpy ``host_fn`` answers it.  Breaker and host-route
    semantics run INSIDE the job, so attribution is exactly the direct
    path's; a racing pipeline shutdown falls back to direct."""
    from .. import device_pipeline, device_supervisor

    def supervised():
        return device_supervisor.run(
            op, device_fn, host_fn=host_fn,
            host_on_failure=device.type != "cuda")

    if device_pipeline.routes_job(device):
        try:
            return device_pipeline.run_job(
                op, supervised, work="epoch_transition", device=device)
        except device_pipeline.PipelineShutdown:
            pass
    return supervised()


def epoch_deltas(arrays, prev_part, inactivity, **kwargs):
    if _EPOCH_BACKEND == "device":
        # The device kernel is fixed int64 and wraps silently on overflow.
        # new_inactivity <= inactivity + bias, so bound-check the worst-case
        # eb * score product on the host and fall back to the exact numpy
        # path (overflow-guarded) when it can't be represented.
        n = arrays.n
        max_eb = int(arrays.effective_balance.max()) if n else 0
        max_inact = int(inactivity.max()) if n else 0
        spec = kwargs["spec"]
        if max_eb * (max_inact + spec.inactivity_score_bias) <= _I64_MAX:
            from ..ops.epoch_device import epoch_deltas_device

            # Supervised (no split retry — the program computes
            # registry-wide participation sums, so halves are not
            # independent).  Pipeline on: the epoch job queues for the
            # shared device arbiter slot, where epoch boundaries contend
            # with block-import bls and tree-hash traffic.
            device = _device()
            op = "epoch_deltas_leak" if kwargs.get("in_leak") else "epoch_deltas"
            return _supervised(
                op,
                lambda: epoch_deltas_device(
                    arrays, prev_part, inactivity, device=device, **kwargs),
                lambda: _epoch_deltas_numpy(
                    arrays, prev_part, inactivity, **kwargs),
                device,
            )
    return _epoch_deltas_numpy(arrays, prev_part, inactivity, **kwargs)


# ------------------------------------------------- fused epoch boundary
#
# With the device backend on and the fused boundary enabled, the whole
# epoch-boundary per-validator pass — deltas, balance application,
# effective-balance hysteresis, registry-update masks, the NEXT epoch's
# attester shuffling and per-slot proposer selection — dispatches as ONE
# supervised, arbiter-slotted device program
# (ops/shuffle_device.py:_boundary_kernel), with the exact numpy composite
# below as the host fallback on the CPU.

_FUSED_BOUNDARY = True


def set_fused_boundary(enabled: bool) -> None:
    """Fuse the epoch boundary into one device dispatch (requires the
    'device' epoch backend; ineligible states fall back to the staged
    path automatically)."""
    global _FUSED_BOUNDARY
    _FUSED_BOUNDARY = bool(enabled)


def _build_boundary_plan(
    state, arrays: EpochArrays, prev_part, inactivity, balances,
    *,
    previous_epoch: int,
    base_reward_per_increment: int,
    total_active_balance: int,
    quotient: int,
    spec: ChainSpec,
):
    """Host-precomputed inputs for one fused boundary dispatch.  Built
    AFTER justification (the activation mask reads the finalized epoch)
    and BEFORE any registry mutation."""
    from ..ops.shuffle_device import BoundaryPlan

    current_epoch = h.get_current_epoch(state, spec)
    next_epoch = current_epoch + 1
    fork = type(state).fork_name
    n = arrays.n
    # Active set at the NEXT epoch is already determined: every epoch
    # transition assigns activation/exit epochs at least one lookahead
    # past next_epoch, so the pre-transition registry snapshot decides it.
    active_idx = np.nonzero(
        (arrays.activation_epoch <= next_epoch)
        & (next_epoch < arrays.exit_epoch)
    )[0].astype(np.int64)
    increment = spec.effective_balance_increment
    hysteresis_increment = increment // spec.preset.hysteresis_quotient
    if fork == "electra":
        eb_cap = np.fromiter(
            (h.get_max_effective_balance(v, spec) for v in state.validators),
            dtype=np.int64, count=n,
        )
        queue_lo, queue_hi = spec.min_activation_balance, 1 << 62
    else:
        eb_cap = np.full(n, spec.max_effective_balance, dtype=np.int64)
        queue_lo = queue_hi = spec.max_effective_balance
    proposer_epoch_seed = h.get_seed(
        state, next_epoch, h.DOMAIN_BEACON_PROPOSER, spec)
    slot_seeds = tuple(
        h.hash(proposer_epoch_seed + h.uint_to_bytes(slot))
        for slot in range(
            next_epoch * spec.slots_per_epoch,
            (next_epoch + 1) * spec.slots_per_epoch,
        )
    )
    return BoundaryPlan(
        effective_balance=arrays.effective_balance,
        activation_epoch=arrays.activation_epoch,
        exit_epoch=arrays.exit_epoch,
        withdrawable_epoch=arrays.withdrawable_epoch,
        slashed=arrays.slashed,
        prev_part=np.asarray(prev_part, dtype=np.int64),
        inactivity=np.asarray(inactivity, dtype=np.int64),
        balance=np.asarray(balances, dtype=np.int64),
        activation_eligibility_epoch=arrays.activation_eligibility_epoch,
        eb_cap=eb_cap,
        active_idx=active_idx,
        attester_seed=h.get_seed(
            state, next_epoch, h.DOMAIN_BEACON_ATTESTER, spec),
        slot_seeds=slot_seeds,
        rounds=spec.preset.shuffle_round_count,
        previous_epoch=previous_epoch,
        base_reward_per_increment=base_reward_per_increment,
        total_active_balance=total_active_balance,
        increment=increment,
        inactivity_score_bias=spec.inactivity_score_bias,
        inactivity_score_recovery_rate=spec.inactivity_score_recovery_rate,
        quotient=quotient,
        current_epoch=current_epoch,
        downward=hysteresis_increment * spec.preset.hysteresis_downward_multiplier,
        upward=hysteresis_increment * spec.preset.hysteresis_upward_multiplier,
        ejection_balance=spec.ejection_balance,
        far_future=min(FAR_FUTURE_EPOCH, 2**63 - 1),
        finalized_epoch=int(state.finalized_checkpoint.epoch),
        max_effective_balance=spec.max_effective_balance,
        queue_lo=queue_lo,
        queue_hi=queue_hi,
    )


def _epoch_boundary_numpy(plan, *, in_leak: bool):
    """Exact numpy composite of the fused boundary kernel — the host
    fallback the supervisor resolves through, bit-identical to the device
    program (chaos tests assert verdict identity)."""
    from hashlib import sha256

    from .shuffling import compute_shuffled_index, shuffle_list

    class _Spec:
        effective_balance_increment = plan.increment
        inactivity_score_bias = plan.inactivity_score_bias
        inactivity_score_recovery_rate = plan.inactivity_score_recovery_rate

    arrays = EpochArrays.__new__(EpochArrays)
    arrays.n = plan.n
    arrays.effective_balance = plan.effective_balance
    arrays.activation_epoch = plan.activation_epoch
    arrays.exit_epoch = plan.exit_epoch
    arrays.withdrawable_epoch = plan.withdrawable_epoch
    arrays.slashed = plan.slashed
    new_inactivity, balance_delta = _epoch_deltas_numpy(
        arrays, plan.prev_part, plan.inactivity,
        previous_epoch=plan.previous_epoch,
        in_leak=in_leak,
        base_reward_per_increment=plan.base_reward_per_increment,
        total_active_balance=plan.total_active_balance,
        quotient=plan.quotient,
        spec=_Spec(),
    )
    # safe-arith: ok(int64 vector apply, deltas bounded by guarded pass)
    new_bal = np.maximum(0, plan.balance + balance_delta)
    eff = plan.effective_balance
    # safe-arith: ok(int64 vector hysteresis, gwei + small thresholds)
    needs = (new_bal + plan.downward < eff) | (eff + plan.upward < new_bal)
    new_eff = np.where(
        needs,
        np.minimum(new_bal - new_bal % plan.increment, plan.eb_cap),
        eff,
    )
    active_cur = (plan.activation_epoch <= plan.current_epoch) & (
        plan.current_epoch < plan.exit_epoch)
    ejection_mask = active_cur & (eff <= plan.ejection_balance)
    queue_mask = (
        (plan.activation_eligibility_epoch == plan.far_future)
        & (eff >= plan.queue_lo)
        & (eff <= plan.queue_hi)
    )
    activation_mask = (
        plan.activation_eligibility_epoch <= plan.finalized_epoch
    ) & (plan.activation_epoch == plan.far_future)
    shuffling = shuffle_list(
        plan.active_idx, plan.attester_seed, plan.rounds
    ).astype(np.int64)
    m = plan.m
    s = len(plan.slot_seeds)
    proposer = np.full(s, -1, dtype=np.int64)
    found = np.zeros(s, dtype=bool)
    if m:
        from ..ops.shuffle_device import PROPOSER_CANDIDATES

        for si, seed in enumerate(plan.slot_seeds):
            for i in range(PROPOSER_CANDIDATES):
                cand = int(plan.active_idx[
                    compute_shuffled_index(i % m, m, seed, plan.rounds)])
                random_byte = sha256(
                    seed + (i // 32).to_bytes(8, "little")).digest()[i % 32]
                if int(new_eff[cand]) * 255 >= (
                        # safe-arith: ok(spec acceptance product, bounded by max_eb*255)
                        plan.max_effective_balance * random_byte):
                    proposer[si] = cand
                    found[si] = True
                    break
    return (new_inactivity, balance_delta,
            np.asarray(new_eff, dtype=np.int64),
            ejection_mask, queue_mask, activation_mask,
            shuffling, proposer, found)


def _run_boundary(plan, *, in_leak: bool):
    """Supervised + pipeline-routed fused boundary dispatch."""
    from ..ops.shuffle_device import epoch_boundary_device

    device = _device()
    op = "epoch_boundary_leak" if in_leak else "epoch_boundary"
    return _supervised(
        op,
        lambda: epoch_boundary_device(plan, in_leak=in_leak, device=device),
        lambda: _epoch_boundary_numpy(plan, in_leak=in_leak),
        device,
    )


def _fused_boundary_eligible(arrays, inactivity, spec: ChainSpec) -> bool:
    """Fused boundary only with the device backend on, the flag set, and
    the int64 overflow guard satisfied (same bound as the staged device
    deltas path)."""
    if _EPOCH_BACKEND != "device" or not _FUSED_BOUNDARY:
        return False
    n = arrays.n
    if not n:
        return False
    max_eb = int(arrays.effective_balance.max())
    max_inact = int(inactivity.max()) if n else 0
    return max_eb * (max_inact + spec.inactivity_score_bias) <= _I64_MAX


def _prime_duty_caches(
    state, plan, shuffling, proposer, found, eff_clean: bool,
    spec: ChainSpec,
) -> None:
    """Seed the freshly-invalidated committee/proposer caches from the
    fused dispatch's outputs — iff the post-transition state still matches
    the plan (the registry-update rules guarantee it in the common case;
    a mismatch just leaves the lazy scalar path in charge)."""
    from .. import device_telemetry

    next_epoch = plan.current_epoch + 1
    active_now = h.get_active_validator_indices(state, next_epoch)
    seed_now = h.get_seed(state, next_epoch, h.DOMAIN_BEACON_ATTESTER, spec)
    if not (
        np.array_equal(active_now, plan.active_idx)
        and seed_now == plan.attester_seed
    ):
        device_telemetry.note_boundary_prime(False, "active_set_changed")
        return
    try:
        cache = h.CommitteeCache.from_precomputed(
            state, next_epoch, spec, active_now, shuffling, seed_now)
    except ValueError:
        device_telemetry.note_boundary_prime(False, "empty_active_set")
        return
    h._caches(state).setdefault("committees", {})[next_epoch] = cache
    # Proposer acceptance read the kernel's post-update effective balances;
    # only seed slots when the live registry ended up with exactly those
    # (no dirty recompute touched any validator, registry length unchanged).
    if eff_clean and len(state.validators) == plan.n:
        pc = h._caches(state).setdefault("proposers", {})
        base_slot = next_epoch * spec.slots_per_epoch
        for si in range(len(plan.slot_seeds)):
            if found[si]:
                pc[base_slot + si] = int(proposer[si])
        device_telemetry.note_boundary_prime(True, "committees+proposers")
    else:
        device_telemetry.note_boundary_prime(True, "committees_only")


def _unslashed_participating_mask(
    arrays: EpochArrays, participation: np.ndarray, flag_index: int, epoch: int
) -> np.ndarray:
    return (
        arrays.active_mask(epoch)
        & ((participation >> flag_index) & 1).astype(bool)
        & ~arrays.slashed
    )


def process_epoch_altair(state, types, spec: ChainSpec) -> None:
    if _EPOCH_BACKEND == "device":
        _device()  # a missing card raises here, before the state changes
    arrays = EpochArrays(state, spec)
    n = arrays.n
    current_epoch = h.get_current_epoch(state, spec)
    previous_epoch = h.get_previous_epoch(state, spec)
    prev_part = _participation_array(state.previous_epoch_participation, n)
    curr_part = _participation_array(state.current_epoch_participation, n)
    balances = _balances_array(state, n)

    increment = spec.effective_balance_increment
    total_active_balance = max(
        increment, int(arrays.effective_balance[arrays.active_mask(current_epoch)].sum())
    )

    # --- justification & finalization
    if current_epoch > GENESIS_EPOCH + 1:
        prev_target = _unslashed_participating_mask(
            arrays, prev_part, TIMELY_TARGET_FLAG_INDEX, previous_epoch
        )
        curr_target = _unslashed_participating_mask(
            arrays, curr_part, TIMELY_TARGET_FLAG_INDEX, current_epoch
        )
        weigh_justification_and_finalization(
            state,
            total_active_balance,
            max(increment, int(arrays.effective_balance[prev_target].sum())),
            max(increment, int(arrays.effective_balance[curr_target].sum())),
            spec,
        )

    in_leak = is_in_inactivity_leak(state, spec)

    # --- inactivity updates + rewards/penalties: the fused per-validator
    # pass (reference single_pass.rs), via the selected array backend
    # (numpy, or the PyTorch program in ops/epoch_device.py).  With the
    # fused boundary on, the whole boundary (deltas + hysteresis + registry
    # masks + next-epoch shuffling/proposers) is ONE device dispatch.
    boundary = plan = None
    if current_epoch > GENESIS_EPOCH:
        inactivity = np.fromiter(state.inactivity_scores, dtype=np.int64, count=n)
        base_reward_per_increment = sa.safe_div(
            sa.safe_mul(increment, spec.base_reward_factor),
            spec.integer_squareroot(total_active_balance),
        )
        fork = type(state).fork_name
        quotient = (
            spec.inactivity_penalty_quotient_altair
            if fork == "altair"
            else spec.inactivity_penalty_quotient_bellatrix
        )
        if _fused_boundary_eligible(arrays, inactivity, spec):
            plan = _build_boundary_plan(
                state, arrays, prev_part, inactivity, balances,
                previous_epoch=previous_epoch,
                base_reward_per_increment=base_reward_per_increment,
                total_active_balance=total_active_balance,
                quotient=quotient,
                spec=spec,
            )
            if plan.m:  # no active validators next epoch: staged path
                boundary = _run_boundary(plan, in_leak=in_leak)
        if boundary is not None:
            (new_inactivity, balance_delta, new_eff, ejection_mask,
             queue_mask, activation_mask, shuffling, proposer,
             proposer_found) = boundary
        else:
            new_inactivity, balance_delta = epoch_deltas(
                arrays, prev_part, inactivity,
                previous_epoch=previous_epoch,
                in_leak=in_leak,
                base_reward_per_increment=base_reward_per_increment,
                total_active_balance=total_active_balance,
                quotient=quotient,
                spec=spec,
            )
        state.inactivity_scores = [int(x) for x in new_inactivity]
        # safe-arith: ok(int64 vector apply, deltas bounded by guarded pass)
        balances = np.maximum(0, balances + balance_delta)
        state.balances = [int(x) for x in balances]

    # --- registry updates, slashings, resets (shared with phase0)
    if boundary is not None:
        _process_registry_updates(
            state, arrays, spec,
            masks=(ejection_mask, queue_mask, activation_mask))
    else:
        _process_registry_updates(state, arrays, spec)
    _process_slashings(state, arrays, balances, total_active_balance, spec)
    _process_eth1_data_reset(state, spec)
    if type(state).fork_name == "electra":
        from .electra import process_pending_consolidations, process_pending_deposits

        process_pending_deposits(state, types, spec)
        process_pending_consolidations(state, types, spec)
    if boundary is not None:
        # `balances` still holds the post-delta snapshot the kernel saw —
        # any index whose live balance has since diverged (slashings,
        # electra deposits/consolidations) is recomputed on the scalar path.
        eff_clean = _process_effective_balance_updates(
            state, arrays, spec,
            precomputed=new_eff, baseline_balances=balances)
    else:
        eff_clean = False
        _process_effective_balance_updates(state, arrays, spec)
    _process_slashings_reset(state, spec)
    _process_randao_mixes_reset(state, spec)
    _process_historical_update(state, types, spec)

    # --- participation flag rotation
    state.previous_epoch_participation = list(state.current_epoch_participation)
    state.current_epoch_participation = [0] * n

    # --- sync committee rotation
    next_epoch = current_epoch + 1
    if next_epoch % spec.preset.epochs_per_sync_committee_period == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = h.get_next_sync_committee(state, types, spec)

    h.invalidate_caches(state)

    # --- duty-cache priming: the fused dispatch already produced the next
    # epoch's shuffling and proposers; seed the fresh caches with them when
    # the post-transition state still matches the plan.
    if boundary is not None:
        _prime_duty_caches(
            state, plan, shuffling, proposer, proposer_found, eff_clean,
            spec)


# ------------------------------------------------------------ phase0 path


def _matching_attestation_sets(state, spec: ChainSpec):
    """(matching_source, matching_target, matching_head) pending attestations
    for the previous epoch, plus per-validator earliest inclusion info."""
    previous_epoch = h.get_previous_epoch(state, spec)
    source_atts = list(state.previous_epoch_attestations)
    target_root = h.get_block_root(state, previous_epoch, spec)
    target_atts = [a for a in source_atts if bytes(a.data.target.root) == bytes(target_root)]
    head_atts = [
        a
        for a in target_atts
        if bytes(a.data.beacon_block_root) == bytes(h.get_block_root_at_slot(state, a.data.slot, spec))
    ]
    return source_atts, target_atts, head_atts


def _attesting_indices_set(state, attestations, spec: ChainSpec) -> set:
    out = set()
    for a in attestations:
        out.update(h.get_attesting_indices(state, a.data, a.aggregation_bits, spec))
    return out


def _unslashed(state, indices: set) -> set:
    return {i for i in indices if not state.validators[i].slashed}


def process_epoch_phase0(state, types, spec: ChainSpec) -> None:
    arrays = EpochArrays(state, spec)
    n = arrays.n
    current_epoch = h.get_current_epoch(state, spec)
    previous_epoch = h.get_previous_epoch(state, spec)
    increment = spec.effective_balance_increment
    total_active_balance = max(
        increment, int(arrays.effective_balance[arrays.active_mask(current_epoch)].sum())
    )

    # --- justification & finalization from pending attestations
    if current_epoch > GENESIS_EPOCH + 1:
        source_atts, target_atts, _ = _matching_attestation_sets(state, spec)
        prev_target_idx = _unslashed(state, _attesting_indices_set(state, target_atts, spec))
        # current-epoch matching target
        cur_target_root = h.get_block_root(state, current_epoch, spec)
        cur_target_atts = [
            a
            for a in state.current_epoch_attestations
            if bytes(a.data.target.root) == bytes(cur_target_root)
        ]
        cur_target_idx = _unslashed(state, _attesting_indices_set(state, cur_target_atts, spec))
        weigh_justification_and_finalization(
            state,
            total_active_balance,
            h.get_total_balance(state, prev_target_idx, spec),
            h.get_total_balance(state, cur_target_idx, spec),
            spec,
        )

    # --- rewards and penalties
    if current_epoch > GENESIS_EPOCH:
        rewards, penalties = _phase0_attestation_deltas(
            state, arrays, total_active_balance, spec
        )
        balances = _balances_array(state, n)
        # safe-arith: ok(int64 vector apply, phase0 deltas bounded)
        balances = np.maximum(0, balances + rewards - penalties)
        state.balances = [int(x) for x in balances]
    else:
        balances = _balances_array(state, n)

    _process_registry_updates(state, arrays, spec)
    _process_slashings(state, arrays, balances, total_active_balance, spec)
    _process_eth1_data_reset(state, spec)
    _process_effective_balance_updates(state, arrays, spec)
    _process_slashings_reset(state, spec)
    _process_randao_mixes_reset(state, spec)
    _process_historical_update(state, types, spec)

    # --- participation record rotation
    state.previous_epoch_attestations = list(state.current_epoch_attestations)
    state.current_epoch_attestations = []

    h.invalidate_caches(state)


def _phase0_attestation_deltas(state, arrays: EpochArrays, total_active_balance: int, spec):
    n = arrays.n
    previous_epoch = h.get_previous_epoch(state, spec)
    increment = spec.effective_balance_increment
    eligible = arrays.eligible_mask(previous_epoch)
    base_reward = (
        arrays.effective_balance
        * spec.base_reward_factor
        // spec.integer_squareroot(total_active_balance)
        // BASE_REWARDS_PER_EPOCH
    )
    rewards = np.zeros(n, dtype=np.int64)
    penalties = np.zeros(n, dtype=np.int64)
    in_leak = is_in_inactivity_leak(state, spec)

    source_atts, target_atts, head_atts = _matching_attestation_sets(state, spec)
    source_idx = _unslashed(state, _attesting_indices_set(state, source_atts, spec))
    target_idx = _unslashed(state, _attesting_indices_set(state, target_atts, spec))
    head_idx = _unslashed(state, _attesting_indices_set(state, head_atts, spec))

    for idx_set in (source_idx, target_idx, head_idx):
        mask = np.zeros(n, dtype=bool)
        if idx_set:
            mask[list(idx_set)] = True
        attesting_balance = max(increment, int(arrays.effective_balance[mask].sum()))
        if in_leak:
            component_reward = base_reward
        else:
            component_reward = (
                base_reward * (attesting_balance // increment)
                // (total_active_balance // increment)
            )
        rewards += np.where(eligible & mask, component_reward, 0)
        penalties += np.where(eligible & ~mask, base_reward, 0)

    # inclusion-delay rewards: earliest inclusion per source-attesting validator
    proposer_reward = base_reward // spec.proposer_reward_quotient
    earliest: Dict[int, Tuple[int, int]] = {}  # index -> (delay, proposer)
    for a in source_atts:
        for i in h.get_attesting_indices(state, a.data, a.aggregation_bits, spec):
            if i in source_idx:
                d = int(a.inclusion_delay)
                if i not in earliest or d < earliest[i][0]:
                    earliest[i] = (d, int(a.proposer_index))
    for i, (delay, proposer) in earliest.items():
        rewards[proposer] += int(proposer_reward[i])
        max_attester_reward = int(base_reward[i]) - int(proposer_reward[i])
        rewards[i] += max_attester_reward // delay

    # inactivity leak penalties
    if in_leak:
        finality_delay = previous_epoch - state.finalized_checkpoint.epoch
        target_mask = np.zeros(n, dtype=bool)
        if target_idx:
            target_mask[list(target_idx)] = True
        penalties += np.where(
            eligible, BASE_REWARDS_PER_EPOCH * base_reward - proposer_reward, 0
        )
        penalties += np.where(
            eligible & ~target_mask,
            arrays.effective_balance * finality_delay // spec.inactivity_penalty_quotient,
            0,
        )
    return rewards, penalties


# ------------------------------------------------------- shared sub-steps


def _process_registry_updates(
    state, arrays: EpochArrays, spec: ChainSpec, masks=None
) -> None:
    """Registry updates; with ``masks`` (the fused boundary's
    ``(ejection, queue, activation)`` per-validator masks) only the flagged
    validators are visited — order-equivalent to the full scan because the
    eligibility write never feeds the same pass's ejection decision, and
    ejections are applied in ascending index order either way (the exit
    queue depends on that order)."""
    current_epoch = h.get_current_epoch(state, spec)
    fork = type(state).fork_name
    if masks is not None:
        ejection_mask, queue_mask, activation_mask = masks
        vs = state.validators
        for index in np.nonzero(queue_mask)[0]:
            vs[int(index)].activation_eligibility_epoch = current_epoch + 1
        for index in np.nonzero(ejection_mask)[0]:
            h.initiate_validator_exit(state, int(index), spec)
        if fork == "electra":
            for index in np.nonzero(activation_mask)[0]:
                vs[int(index)].activation_epoch = (
                    h.compute_activation_exit_epoch(current_epoch, spec))
            return
        queue = sorted(
            (int(i) for i in np.nonzero(activation_mask)[0]),
            key=lambda i: (vs[i].activation_eligibility_epoch, i),
        )
        churn = h.get_validator_activation_churn_limit(state, spec)
        for index in queue[:churn]:
            vs[index].activation_epoch = h.compute_activation_exit_epoch(
                current_epoch, spec
            )
        return
    # eligibility + ejections
    for index, v in enumerate(state.validators):
        if h.is_eligible_for_activation_queue(v, spec, fork=fork):
            v.activation_eligibility_epoch = current_epoch + 1
        if (
            h.is_active_validator(v, current_epoch)
            and v.effective_balance <= spec.ejection_balance
        ):
            h.initiate_validator_exit(state, index, spec)
    if fork == "electra":
        # EIP-7251: no activation-count churn — churn moved to the
        # balance-weighted pending-deposit queue.
        for index, v in enumerate(state.validators):
            if h.is_eligible_for_activation(state, v):
                v.activation_epoch = h.compute_activation_exit_epoch(
                    current_epoch, spec
                )
        return
    # dequeue activations up to churn
    queue = sorted(
        (
            index
            for index, v in enumerate(state.validators)
            if h.is_eligible_for_activation(state, v)
        ),
        key=lambda i: (state.validators[i].activation_eligibility_epoch, i),
    )
    churn = h.get_validator_activation_churn_limit(state, spec)
    for index in queue[:churn]:
        state.validators[index].activation_epoch = h.compute_activation_exit_epoch(
            current_epoch, spec
        )


def _process_slashings(
    state, arrays: EpochArrays, balances: np.ndarray, total_balance: int, spec: ChainSpec
) -> None:
    fork = type(state).fork_name
    epoch = h.get_current_epoch(state, spec)
    if fork == "phase0":
        multiplier = spec.proportional_slashing_multiplier
    elif fork == "altair":
        multiplier = spec.proportional_slashing_multiplier_altair
    else:
        multiplier = spec.proportional_slashing_multiplier_bellatrix
    adjusted_total = min(
        sa.safe_mul(sum(int(x) for x in state.slashings), multiplier), total_balance
    )
    increment = spec.effective_balance_increment
    target_epoch = epoch + spec.preset.epochs_per_slashings_vector // 2  # safe-arith: ok(epoch arithmetic, not gwei)
    mask = arrays.slashed & (arrays.withdrawable_epoch == target_epoch)
    if not mask.any():
        return
    # Exact Python-int penalties for the (few) validators being slashed this
    # epoch: the eb//increment * adjusted_total product wraps int64 on large
    # registries, and the reference computes this with checked u64 math.
    penalty_per_increment = (
        sa.safe_div(adjusted_total, total_balance // increment)
        if fork == "electra"
        else 0
    )
    for index in np.nonzero(mask)[0]:
        idx = int(index)
        increments_i = int(arrays.effective_balance[idx]) // increment
        if fork == "electra":
            # EIP-7251: per-increment penalty (avoids the u64 overflow of
            # the eb * adjusted_total product at 2048-ETH effective balances)
            penalty_i = sa.safe_mul(increments_i, penalty_per_increment)
        else:
            penalty_numerator = sa.safe_mul(increments_i, adjusted_total)
            penalty_i = sa.safe_mul(
                sa.safe_div(penalty_numerator, total_balance), increment
            )
        h.decrease_balance(state, idx, penalty_i)


def _process_eth1_data_reset(state, spec: ChainSpec) -> None:
    next_epoch = h.get_current_epoch(state, spec) + 1
    if next_epoch % spec.preset.epochs_per_eth1_voting_period == 0:
        state.eth1_data_votes = []


def _process_effective_balance_updates(
    state, arrays: EpochArrays, spec: ChainSpec,
    precomputed=None, baseline_balances=None,
) -> bool:
    """Effective-balance hysteresis.  With ``precomputed`` (the fused
    boundary's per-validator new effective balances, computed from the
    ``baseline_balances`` post-delta snapshot), clean validators take the
    kernel's answer directly and only DIRTY indices — live balance diverged
    from the snapshot (slashings, electra deposits/consolidations) or rows
    appended after the snapshot — rerun the scalar spec body.  Returns True
    iff every validator ended up with exactly the precomputed value (the
    proposer-cache priming gate)."""
    increment = spec.effective_balance_increment
    hysteresis_increment = increment // spec.preset.hysteresis_quotient
    downward = hysteresis_increment * spec.preset.hysteresis_downward_multiplier
    upward = hysteresis_increment * spec.preset.hysteresis_upward_multiplier
    is_electra = type(state).fork_name == "electra"

    def scalar_update(index: int, v) -> None:
        balance = int(state.balances[index])
        if (
            sa.safe_add(balance, downward) < v.effective_balance
            or sa.safe_add(int(v.effective_balance), upward) < balance
        ):
            cap = (
                h.get_max_effective_balance(v, spec)  # EIP-7251 per-credential cap
                if is_electra
                else spec.max_effective_balance
            )
            v.effective_balance = min(
                sa.safe_sub(balance, sa.safe_mod(balance, increment)), cap
            )

    if precomputed is not None:
        vs = state.validators
        n0 = arrays.n
        final = _balances_array(state, len(vs))
        clean = final[:n0] == baseline_balances
        changed = clean & (precomputed != arrays.effective_balance)
        for index in np.nonzero(changed)[0]:
            vs[int(index)].effective_balance = int(precomputed[index])
        dirty = [int(i) for i in np.nonzero(~clean)[0]]
        appended = list(range(n0, len(vs)))
        for index in dirty + appended:
            scalar_update(index, vs[index])
        return not dirty and not appended

    for index, v in enumerate(state.validators):
        scalar_update(index, v)
    return False


def _process_slashings_reset(state, spec: ChainSpec) -> None:
    next_epoch = h.get_current_epoch(state, spec) + 1
    state.slashings[next_epoch % spec.preset.epochs_per_slashings_vector] = 0


def _process_randao_mixes_reset(state, spec: ChainSpec) -> None:
    current_epoch = h.get_current_epoch(state, spec)
    next_epoch = current_epoch + 1
    state.randao_mixes[next_epoch % spec.preset.epochs_per_historical_vector] = h.get_randao_mix(
        state, current_epoch, spec
    )


def _process_historical_update(state, types, spec: ChainSpec) -> None:
    next_epoch = h.get_current_epoch(state, spec) + 1
    if next_epoch % (spec.preset.slots_per_historical_root // spec.slots_per_epoch) != 0:
        return
    fork = type(state).fork_name
    if fork in ("phase0", "altair", "bellatrix"):
        batch = types.HistoricalBatch(
            block_roots=list(state.block_roots), state_roots=list(state.state_roots)
        )
        state.historical_roots = list(state.historical_roots) + [batch.hash_tree_root()]
    else:
        summary = types.HistoricalSummary(
            block_summary_root=state.fields["block_roots"].hash_tree_root(state.block_roots),
            state_summary_root=state.fields["state_roots"].hash_tree_root(state.state_roots),
        )
        state.historical_summaries = list(state.historical_summaries) + [summary]


# ---------------------------------------------------------------- dispatch


def process_epoch(state, types, spec: ChainSpec) -> None:
    if type(state).fork_name == "phase0":
        process_epoch_phase0(state, types, spec)
    else:
        process_epoch_altair(state, types, spec)
