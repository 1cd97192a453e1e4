"""State-transition timing script — the role of the reference's
``lcli transition-blocks --runs N`` / ``skip-slots`` wall-clock loops
(`lcli/src/transition_blocks.rs`, `lcli/src/skip_slots.rs`) and the
16,384-validator criterion benches (`consensus/types/benches/benches.rs:11-50`).

Builds an N-validator state (synthetic registry — no real key derivation, the
transition never checks signatures here), then times:

- full ``hash_tree_root`` (cold cache)
- re-hash after one balance change (the incremental-cache headline)
- ``state.copy()``
- ``process_slots`` across one epoch boundary, hashing every slot (the
  per-slot hot loop every block import pays)

Toggle the incremental cache with LIGHTHOUSE_TPU_TREE_CACHE=0/1 and the
native SHA-256 with LIGHTHOUSE_TPU_NATIVE_SHA=0/1 for before/after numbers:

    python -m lighthouse_tpu_torch.transition_bench --validators 16384
    LIGHTHOUSE_TPU_TREE_CACHE=0 python -m lighthouse_tpu_torch.transition_bench ...

A port of the JAX package's ``scripts/transition_bench.py`` that imports
only the port (``lcli transition-bench`` runs it).  Tree hashing and the
epoch programs run on ``--device`` (the card by default; ``cpu`` runs the
CUDA kernels' plain versions), and ``--epoch-backends`` times the numpy
epoch-deltas pass against ``ops.epoch_device.epoch_deltas_device`` there.
"""

from __future__ import annotations

import argparse
import json
import time


def build_state(n_validators: int):
    from hashlib import sha256

    from .consensus.genesis import interop_withdrawal_credentials
    from .types.containers import build_types
    from .types.spec import FAR_FUTURE_EPOCH, minimal_spec

    spec = minimal_spec(
        altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
        deneb_fork_epoch=None,
    )
    types = build_types(spec.preset)

    # Synthetic genesis: fake-but-distinct pubkeys (the transition here never
    # verifies signatures; key derivation for 16k real keys is minutes).
    state = types.state["capella"]()
    state.genesis_time = 1_600_000_000
    state.genesis_validators_root = b"\x01" * 32
    state.fork = types.Fork(
        previous_version=spec.capella_fork_version,
        current_version=spec.capella_fork_version,
        epoch=0,
    )
    mb = spec.max_effective_balance
    for i in range(n_validators):
        pk = sha256(b"pk" + i.to_bytes(8, "little")).digest() + b"\x00" * 16
        state.validators.append(types.Validator(
            pubkey=pk[:48],
            withdrawal_credentials=interop_withdrawal_credentials(pk[:48]),
            effective_balance=mb,
            activation_eligibility_epoch=0,
            activation_epoch=0,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        ))
        state.balances.append(mb)
        state.previous_epoch_participation.append(0b111)
        state.current_epoch_participation.append(0b111)
        state.inactivity_scores.append(0)
    state.latest_block_header = types.BeaconBlockHeader(
        body_root=types.block_body["capella"]().hash_tree_root()
    )
    # Synthetic sync committees (the fake pubkeys cannot be aggregated; the
    # fake-crypto backend below keeps any later period rotation happy).
    size = spec.preset.sync_committee_size
    committee = types.SyncCommittee(
        pubkeys=[bytes(state.validators[i % n_validators].pubkey) for i in range(size)],
        aggregate_pubkey=bytes(state.validators[0].pubkey),
    )
    state.current_sync_committee = committee
    state.next_sync_committee = committee.copy()
    return state, types, spec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m lighthouse_tpu_torch.transition_bench")
    ap.add_argument("--validators", type=int, default=16384)
    ap.add_argument("--slots", type=int, default=None,
                    help="slots to advance (default: one epoch + 1)")
    ap.add_argument("--epoch-backends", action="store_true",
                    help="also time the epoch-deltas pass: numpy vs the PyTorch "
                         "program (ops/epoch_device.py) on --device")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where tree hashing and the epoch programs run")
    args = ap.parse_args(argv)

    from .consensus import per_epoch
    from .consensus.per_slot import process_slots
    from .crypto.bls.backends import set_backend
    from .ops import tree_hash
    from .types import ssz as ssz_mod

    set_backend("fake")  # no signature work in this bench
    tree_hash.configure(enabled=True, device=args.device)
    per_epoch.configure(backend="device", device=args.device)

    t0 = time.perf_counter()
    state, types, spec = build_state(args.validators)
    build_secs = time.perf_counter() - t0
    n_slots = args.slots if args.slots is not None else spec.slots_per_epoch + 1

    out = {
        "validators": args.validators,
        "device": args.device,
        "tree_cache": ssz_mod._TREE_CACHE_ENABLED,
        "native_sha": ssz_mod._hash_pairs is not ssz_mod._hash_pairs_hashlib,
        "build_secs": round(build_secs, 2),
    }

    t0 = time.perf_counter()
    root0 = state.hash_tree_root()
    out["hash_cold_secs"] = round(time.perf_counter() - t0, 4)

    state.balances[1] += 1
    t0 = time.perf_counter()
    state.hash_tree_root()
    out["hash_one_change_secs"] = round(time.perf_counter() - t0, 6)

    t0 = time.perf_counter()
    work = state.copy()
    out["copy_secs"] = round(time.perf_counter() - t0, 4)

    t0 = time.perf_counter()
    work = process_slots(work, int(work.slot) + n_slots, types, spec)
    dt = time.perf_counter() - t0
    out["process_slots_secs"] = round(dt, 3)
    out["slots_per_sec"] = round(n_slots / dt, 2)
    out["slots"] = n_slots

    # Block-apply phase: every committee of a slot attests with full bits
    # (the reference's transition-blocks semantics at realistic block load).
    from .consensus import helpers as h
    from .consensus.per_block import process_attestation

    slot = int(work.slot) - 1
    epoch = slot // spec.slots_per_epoch
    committees = h.get_committee_count_per_slot(work, epoch, spec)
    atts = []
    attesters = 0
    for index in range(committees):
        committee = h.get_beacon_committee(work, slot, index, spec)
        attesters += len(committee)
        data = types.AttestationData(
            slot=slot, index=index,
            beacon_block_root=bytes(work.block_roots[slot % spec.preset.slots_per_historical_root]),
            source=work.current_justified_checkpoint.copy(),
            target=types.Checkpoint(
                epoch=epoch,
                root=bytes(work.block_roots[
                    (epoch * spec.slots_per_epoch) % spec.preset.slots_per_historical_root
                ]),
            ),
        )
        atts.append(types.Attestation(
            aggregation_bits=[True] * len(committee), data=data,
            signature=b"\xc0" + b"\x00" * 95,
        ))
    t0 = time.perf_counter()
    for att in atts:
        process_attestation(work, att, types, spec, verify=False)
    dt = time.perf_counter() - t0
    out["attestations_applied"] = len(atts)
    out["attesters_covered"] = attesters
    out["attestation_apply_secs"] = round(dt, 4)

    # Epoch-deltas phase at full registry scale: numpy vs the device
    # program (the fused per-validator pass of single_pass.rs — at 1M
    # validators it is pure memory-bound vector math).
    if args.epoch_backends:
        import numpy as np

        from .consensus import per_epoch as pe
        from .ops.epoch_device import epoch_deltas_device

        arrays = pe.EpochArrays(work, spec)
        n = arrays.n
        rng = np.random.default_rng(3)
        prev_part = rng.integers(0, 8, n)
        inact = rng.integers(0, 100, n)
        epoch = int(work.slot) // spec.slots_per_epoch
        tab = max(
            spec.effective_balance_increment,
            int(arrays.effective_balance[arrays.active_mask(epoch)].sum()),
        )
        kw = dict(
            previous_epoch=max(0, epoch - 1), in_leak=False,
            base_reward_per_increment=(
                spec.effective_balance_increment * spec.base_reward_factor
                // spec.integer_squareroot(tab)),
            total_active_balance=tab,
            quotient=spec.inactivity_penalty_quotient_bellatrix, spec=spec,
        )
        t0 = time.perf_counter()
        host = pe._epoch_deltas_numpy(arrays, prev_part, inact.copy(), **kw)
        out["epoch_deltas_numpy_secs"] = round(time.perf_counter() - t0, 4)
        kw["device"] = args.device
        dev = epoch_deltas_device(arrays, prev_part, inact.copy(), **kw)  # warm-up
        t0 = time.perf_counter()
        dev = epoch_deltas_device(arrays, prev_part, inact.copy(), **kw)
        out["epoch_deltas_device_secs"] = round(time.perf_counter() - t0, 4)
        out["epoch_deltas_match"] = bool(
            np.array_equal(host[0], dev[0]) and np.array_equal(host[1], dev[1])
        )

    print(json.dumps(out))


if __name__ == "__main__":
    main()
