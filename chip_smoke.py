#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lighthouse_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on a failed check:

1. card    — the card's name and power limit, as nvidia-smi reports them;
2. build   — nvcc builds csrc/fq_mul.cu, csrc/sha256.cu and csrc/shuffle.cu
             for sm_90a, one process per source started together (times and
             -Xptxas -v);
3. kernels — both Fq kernels against their plain PyTorch versions on the
             card, limb for limb, on canonical, redundant, negative and edge
             inputs at n in KERNEL_NS (block edges of both kernels), with values checked
             against Python integers on a sample;
   hash-kernels — both SHA-256 kernels against their plain versions on the
             card, word for word: sha256_pairs at n in PAIR_NS (up to the
             top bucket, 262,144 blocks, and the edges of its CUDA blocks),
             tree_hash_subtrees at m in SUBTREE_MS (up to 32,768 subtrees,
             a 2^20-leaf level) and on both sides of each step of its
             threads-a-subtree table, through the default entry and at every
             T of ``cuda_sha.SUBTREE_THREADS``; the default entry's digests
             also against hashlib on every row up to 1,000 and on 1,000
             seeded rows above that;
   epoch-kernels — both epoch kernels against their plain versions on the
             card at each registry bucket up to 2^20 and one below it
             (EPOCH_NS): shuffle_round over the mainnet preset's 90 rounds,
             also against the host ``shuffle_list`` up to 65,536 lanes and
             at 2^20; proposer_walk over 32 slots x 64 candidates at its
             default lookahead, against the host ``compute_shuffled_index``
             at every size, and at every lookahead of
             ``cuda_epoch.WALK_LOOKAHEADS`` against its plain version at 63
             and 2^20 with 90 and 10 rounds;
4. verify  — ``crypto.bls.api.verify_signature_sets`` through the torch
             backend (default device, supervised) at 128 sets x 32 keys (valid -> True,
             one tampered set -> False) and 64 sets x 1 key (-> True); the
             launch counters of both kernels must rise during the 128 x 32 run;
5. parity  — a fixed-seed 4 x 4 batch on the card and on the CPU: the two
             final-exponentiation outputs must be equal limb for limb;
6. kzg     — the vendored mainnet trusted setup (tests/vectors/
             mainnet_trusted_setup.json, 4096 field elements a blob), six
             blobs from a seed committed and proved on the host; then
             ``Kzg(setup).verify_blob_kzg_proof_batch`` at the default device
             on the six (valid -> True, two proofs swapped -> False) and
             ``ops.kzg_device.verify_kzg_proof_batch_device`` on 192 lanes,
             the six tiled 32 times (valid -> True, one y + 1 -> False); the
             launch counters of both kernels must rise in each valid run;
             one traced run of the 192-lane program (torch.profiler);
7. kzg parity — a fixed-seed 2-blob batch of the KZG device program on the
             card and on the CPU: ``fe`` equal limb for limb;
8. runtime — the device runtime at full width: ``device_pipeline.enable()``
             on the card, then from ten threads at once one 128 x 32
             block-import group, eight 8 x 1 gossip groups and one 8 x 1
             group with a tampered signature, through
             ``api.verify_signature_sets``; every verdict as expected (only
             the tampered group False), at least one batch of two or more
             groups, no host fallback, breakers closed; the same groups
             again with the pipeline off (each caller's own supervised
             batch), for the wall time beside; then a 6-blob
             ``Kzg.verify_blob_kzg_proof_batch`` under the supervisor with
             the same checks;
9. hash-runtime — both pipelines on the card at once: eight threads each
             bring a 2^18-leaf ``ops.tree_hash.DeviceLeafTree`` to a 1 %-dirty
             version (dirty-path pair batches through the hash pipeline)
             while a ninth verifies one 128 x 32 group through the bls
             pipeline; every root equals ``golden_root``, the verdict is
             True, at least one hash batch coalesced two or more groups,
             the shared arbiter granted both ops, no host fallback;
10. state  — BeaconState tree hashing at mainnet width on the default
             device: a Deneb mainnet-preset state of 2^20 validators from a
             seed; its root with ``tree_hash.configure(enabled=True)`` and
             ``install_device_hash()``, then after one slot's changes in two
             steps (1 % of balances and 64 effective balances; then 16
             appended validators); each root equal to the root the host
             engines compute on the native kernel, both kernels launched
             (counts set to 0 just before the first root, read after the
             last), no host fallback, breakers closed; blocks and seconds
             per route (card via the subtree kernel, card via the pair
             kernel, host below a threshold, host above the top bucket),
             host and device seconds apart;
11. epoch  — the epoch boundary at mainnet width on the card: a Deneb
             mainnet-preset state of 2^20 validators one slot before a
             boundary, from a seed (``workload.boundary_state``: ejections,
             the activation queue, pending activations, slashed
             validators); the staged ``epoch_deltas_device`` once on its
             registry against the numpy pass; then it crosses the boundary
             through ``per_slot.process_slots``
             with the fused boundary on the card, once in an inactivity
             leak and once not; each result equals a numpy-backend run of
             the port on a copy of the state in balances, inactivity,
             validator fields, committees, proposers and state root, with
             no host fallback; host seconds, device seconds (flight record)
             and the kernels' launches (counts set to 0 just before the
             first boundary, read after the last; both kernels must have
             run);
12. block  — block import at mainnet width on the default device: a Deneb
             mainnet-preset state of 2^20 validators at the first slot of
             an epoch and the full block a mainnet proposer packs for the
             next slot, every signature real, from a seed
             (``workload.block_import_case``: 128 attestations of the 64
             committees of the previous slot, a 95 % sync aggregate, a
             proposer and an attester slashing, an exit, a BLS change, 16
             withdrawals, 300 transactions, 6 blob commitments; the
             block's state root from a host run without verification); the
             port's pubkey cache warmed with the block's keys and the
             state's hash cache with one full root, both before the import
             and printed; then ``state_transition`` with ``VERIFY_BULK``:
             the block's signatures in one supervised bls_verify batch on
             the card (its bucket and stages from the flight record, no
             host fallback, breakers closed), the post-state equal to the
             host run's (root, balances, participation, validators, SSZ
             bytes), all four kernels launched (counts set to 0 just before
             the import, read just after); host seconds split into
             process_slots, signature-set collection, the verify's setup,
             the operations and the root; fork choice anchored at the
             pre-state takes the block and its attestations, its head is
             the block and the anchor's weight the attesters' effective
             balances; a copy of the pre-state refuses the block with two
             attestation signatures swapped (``BlockProcessingError``, the
             batch's verdict False on the card) and with its state root
             off by one byte (``StateRootMismatch``);
13. faults — the supervisor's routes on the card at small size, each with
             its exact counter deltas and none with a host fallback (on
             the card a failure raises into the caller): a
             ``device.dispatch`` error on a 4-set batch (split retry, both
             halves on the card), a hang past a short deadline (watchdog,
             ``DispatchTimeout`` raised), errors up to the breaker
             threshold (each raised; OPEN, then ``RequeueWork`` raised
             without a launch, then HALF_OPEN probes on the card back to
             CLOSED), a ``corrupt`` verdict, and a ``kzg_batch`` dispatch
             error on 2 blobs (no split, the error raised); on the hashing
             ops, a ``device.dispatch`` error on sha256_pairs and on
             tree_hash (split retry, both halves on the card, bytes equal to
             the golden), a hang on tree_hash (``DispatchTimeout`` raised),
             and an error on every sha256_pairs dispatch under the hash
             pipeline (both groups' futures raise, nothing re-hashed on the
             host); and an ``epoch_boundary`` dispatch error on a 4,096-
             validator boundary (no split, raised, the numpy composite never
             runs); a ``device.dispatch`` error on the verify batch of a
             4,096-validator block import (split retry, both halves on the
             card, the block imports with its root);
14. timing — each kernel and its plain version at the largest shape the
             128 x 32 run gave it, beside the least time the card could take;
             then each kernel at every launch size of that run (the
             histogram ``cuda_fq.SIZES``), summed to its time per verify,
             beside its bound per verify, and likewise per 6-blob and per
             192-lane KZG batch and per [block] import; each SHA-256 kernel
             at its top bucket and at every launch size of the [state] run
             and of the [block] import, beside its bound and
             plain version, its launches per state root, and the native
             host pair hasher's rate; the subtree kernel at every T at each
             [state] size, in turns, and summed over the run's launches;
             each epoch kernel at its [epoch] launch (a round of the 2^20
             shuffle; the 32 x 64-lane walk) beside its bound and plain
             version, the walk at every lookahead and alone on one lane
             (its latency floor), in turns; the redesigned kernels' log
             lines beside their earlier designs' times as PERF.md records
             them (EARLIER_MS, not measured here); the two epoch PyTorch
             programs (deltas, the fused boundary) at 2^20, the boundary
             also on the kernels' plain versions and once under
             torch.profiler.  Kernel times are device times of
             launches replayed from a CUDA graph, so the host's launch
             overhead does not count.

Every verify, KZG, hash and epoch batch of phases 4, 6, 8, 9, 10, 11 and 12 runs through
the device supervisor (``device_supervisor.py``); the script fails if any
of them took the host route or left a breaker open.  Per-batch stages come from
the flight recorder (``device_telemetry``).

The line before the last is one JSON object naming every kernel with its
numbers; the last line is ``{"ok": true, "device": {...}}``.  Without CUDA,
or outside the repository, the script exits non-zero and prints no result.
It needs no network and leaves no process running.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path

#: H100 SXM memory rate (bytes/s).  The operations per product and the
#: card's IMAD rate are in lighthouse_tpu_torch/bench_kernels.py.
HBM_BYTES_PER_S = 3.35e12
#: Bytes one row moves (two operands in, one result out), per kernel.
KERNELS = {
    "fq_mul": {"bytes": 3 * 25 * 4, "replaces": "lighthouse_tpu/ops/pallas_fq.py:122"},
    "fq2_mul": {"bytes": 3 * 2 * 25 * 4, "replaces": "lighthouse_tpu/ops/pallas_fq.py:131"},
}
SOURCE = "lighthouse_tpu_torch/csrc/fq_mul.cu"
#: Kernel check sizes; the main path's (sets, keys); the gossip batch.
KERNEL_NS = (1, 3, 5, 7, 15, 17, 127, 128, 129, 65536)
MAIN = (128, 32)
GOSSIP = (64, 1)
#: KZG: blobs per block (MAX_BLOBS_PER_BLOCK of the mainnet Deneb preset),
#: lanes of the Deneb target (6 blobs x 32 blocks), the trusted setup.
KZG_BLOBS = 6
KZG_LANES = 192
KZG_SETUP = Path(__file__).resolve().parent / "tests" / "vectors" / "mainnet_trusted_setup.json"
#: Runtime phase: the pipeline's pinned linger (s).  Fault phase: the short
#: watchdog deadline of the hang case and the injected hang (s).
RUNTIME_LINGER_S = 0.1
HANG_DEADLINE_S = 3.0
HANG_SLEEP_S = 6.0
#: The hashing slice's two kernels: bytes one row moves (a 64-byte block in
#: and its 32-byte digest out; a subtree's 32 leaves in and its 31 interior
#: nodes out) and the integer operations one row needs (csrc/sha256.cu: a
#: round is 14 operations, a message schedule step 10, the padding block's
#: schedule is constant: 64 x 14 + 48 x 10 + 8 + 64 x 14 + 8 a block).
SHA_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8 + 64 * 14 + 8
SHA_KERNELS = {
    "sha256_pairs": {"bytes": 64 + 32, "ops": SHA_OPS_PER_BLOCK,
                     "replaces": "lighthouse_tpu/ops/sha256_device.py:135"},
    "tree_hash_subtrees": {"bytes": 32 * 32 + 31 * 32, "ops": 31 * SHA_OPS_PER_BLOCK,
                           "replaces": "lighthouse_tpu/ops/tree_hash.py:176"},
}
SHA_SOURCE = "lighthouse_tpu_torch/csrc/sha256.cu"
#: The card's 32-bit integer issue rate: 64 operations per clock per SM.
INT_OPS_PER_CLK_PER_SM = 64
SMS = 132
#: [hash-kernels] sizes: the pair kernel's block counts (its top bucket and
#: the edges of its 256-thread CUDA blocks) and the subtree kernel's subtree
#: counts (its top bucket, a 2^20-leaf level, the edges of its 8-subtree
#: CUDA blocks at T = 16, and both sides of each step of its T table, which
#: steps at the caller's buckets 128 and 2,048); hashlib checks every row
#: up to HASHLIB_ALL rows and HASHLIB_ALL seeded rows above that.
PAIR_NS = (1, 31, 255, 256, 257, 511, 512, 513, 1000, 65536, 262144)
SUBTREE_MS = (1, 3, 7, 8, 9, 15, 16, 17, 128, 129, 2048, 2049, 32768)
HASHLIB_ALL = 1000
#: The earlier designs' times of the subtree kernel (16 threads a subtree,
#: a level at a time) and the walk (one thread a lane, a round a step), as
#: PERF.md §6 records them (a chip_smoke.py run on an NVIDIA H100 80GB HBM3,
#: 700.00 W): printed in the [timing] log beside this run's times, and in
#: no result, since this run does not measure them.  The subtree kernel at
#: each [state] launch size and over the [state] run's 34 launches, the
#: walk at 32 x 64 lanes x 90 rounds.
EARLIER_MS = {
    "tree_hash_subtrees": {"by_size": {8: 0.0148, 128: 0.0152, 2048: 0.0266, 32768: 0.3669},
                           "state": 2.773},
    "proposer_walk": {"ms": 0.1267},
}
#: [state]: validators in the registry (the order of mainnet's, the top of
#: the JAX package's epoch buckets); the slot's changes (the JAX package's
#: bench STATE_DIRTY_FRACTION of the balances, effective balances,
#: deposits).
STATE_VALIDATORS = 1 << 20
STATE_DIRTY_FRACTION = 0.01
STATE_EFFECTIVE = 64
STATE_APPENDED = 16
#: [hash-runtime]: threads updating their own tree, leaves a tree, dirty
#: share of an update.
HASH_THREADS = 8
HASH_TREE_LEAVES = 1 << 18
HASH_DIRTY_FRACTION = 0.01
#: The epoch slice's two kernels (csrc/shuffle.cu).  A shuffle round moves
#: 4 bytes in and 4 out a lane plus its digest row (one bit a lane); the
#: proposer walk does one compression a lane a round on a few bytes of seeds
#: and pivots, of which rounds 0-7 and schedule words W16 .. W22 read only
#: the seed and are done once a slot (csrc/sha256_compress.cuh: a round 14
#: operations, a schedule step 10): 56 x 14 + 41 x 10 + 8 a lane a round,
#: 8 x 14 + 7 x 10 a slot.
SHUFFLE_SOURCE = "lighthouse_tpu_torch/csrc/shuffle.cu"
WALK_OPS_PER_ROUND = 56 * 14 + 41 * 10 + 8
WALK_OPS_PER_SLOT = 8 * 14 + 7 * 10
EPOCH_KERNELS = {
    "shuffle_round": {"replaces": "lighthouse_tpu/ops/shuffle_device.py:112"},
    "proposer_walk": {"replaces": "lighthouse_tpu/ops/shuffle_device.py:186"},
}
#: [epoch-kernels] and [epoch]: the mainnet preset's shuffle rounds, slots
#: and proposer candidates; registry sizes checked (each bucket and one
#: below it); the [epoch] registry (the top of the JAX package's epoch
#: buckets, the order of mainnet's) and the [faults] epoch registry.
SHUFFLE_ROUNDS = 90
EPOCH_SLOTS = 32
EPOCH_NS = (1, 2, 63, 64, 255, 256, 1023, 1024, 4095, 4096, 16384, 65536, 262144,
            1048575, 1048576)
EPOCH_HOST_MAX = 65536
#: The walk's rounds checked at every lookahead: the mainnet and minimal
#: presets' shuffle_round_count.
WALK_CHECK_ROUNDS = (90, 10)
EPOCH_VALIDATORS = 1 << 20
EPOCH_FAULT_VALIDATORS = 4096
#: [block]: validators in the registry (mainnet's order), the [faults]
#: block's registry, and the seed both cases are made from.
BLOCK_VALIDATORS = 1 << 20
BLOCK_FAULT_VALIDATORS = 4096
BLOCK_SEED = 0xB10C
#: The supervisor's counters whose deltas each fault case asserts.
SUPERVISOR_COUNTERS = {
    "host_fallbacks": "DEVICE_HOST_FALLBACK",
    "dispatch_timeouts": "DEVICE_DISPATCH_TIMEOUTS",
    "split_retries": "DEVICE_SPLIT_RETRIES",
    "breaker_transitions": "DEVICE_BREAKER_TRANSITIONS",
}


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi(fields: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs


def rand_values(rng: random.Random, n: int) -> list:
    from lighthouse_tpu_torch.crypto.bls.params import P

    return [rng.getrandbits(384) % P for _ in range(n)]


def limbs(values) -> "torch.Tensor":
    import numpy as np
    import torch

    from lighthouse_tpu_torch.ops.fq import to_limbs16

    return torch.as_tensor(np.stack([to_limbs16(v) for v in values]))


def operand_cases(rng: random.Random, n: int) -> dict:
    """(a, b, value_a, value_b) per input family; values are the integers the
    limb rows stand for (redundant and negative rows included)."""
    from lighthouse_tpu_torch.crypto.bls.params import P

    va, vb = rand_values(rng, n), rand_values(rng, n)
    a, b = limbs(va), limbs(vb)
    edge = [0, 1, P - 1, P - 2]
    ve = [edge[i % 4] for i in range(n)]
    vf = [edge[(i // 4 + 1) % 4] for i in range(n)]
    return {
        "canonical": (a, b, va, vb),
        "redundant": (a * 37 - b * 12, b * 55 - a * 3,
                      [37 * x - 12 * y for x, y in zip(va, vb)],
                      [55 * y - 3 * x for x, y in zip(va, vb)]),
        "negative": (-a, -(b * 3), [-x for x in va], [-3 * y for y in vb]),
        "edge": (limbs(ve), limbs(vf), ve, vf),
    }


def sample_rows(n: int) -> list:
    return sorted({0, n // 2, n - 1} | set(range(min(n, 4))))


# ------------------------------------------------------------------ phases


def phase_build() -> dict:
    from lighthouse_tpu_torch.ops import compile_cache, cuda_build

    t0 = time.perf_counter()
    results = compile_cache.build_kernels(force=True)
    wall = time.perf_counter() - t0
    for name, res in results.items():
        log(f"[build] {name}: nvcc {' '.join(cuda_build.NVCC_FLAGS)}: {res.seconds:.1f} s -> "
            f"{res.path.name}")
        for line in cuda_build.ptxas_summary(res.log):
            log(f"[build] {name}: {line}")
    log(f"[build] {len(results)} sources built at once in {wall:.1f} s")
    return {"seconds": {name: res.seconds for name, res in results.items()}, "wall_s": wall}


def phase_kernels(cuda_fq) -> dict:
    import torch

    from lighthouse_tpu_torch.crypto.bls.params import P
    from lighthouse_tpu_torch.ops.fq import from_limbs16

    rng = random.Random(0x5EED)
    max_err = {"fq_mul": 0, "fq2_mul": 0}
    # Output limb bounds: 2^16.3 for an Fq product; the Fq2 recombination
    # t2 - t0 - t1 adds up to three of them.
    bound = {"fq_mul": 80685, "fq2_mul": 3 * 80685}
    for n in KERNEL_NS:
        for kind, (a, b, va, vb) in operand_cases(rng, n).items():
            a, b = a.cuda(), b.cuda()
            k = cuda_fq.fq_mul(a, b)
            p = cuda_fq.fq_mul_plain(a, b)
            # Fq2 rows: (a, b rolled) x (b, a rolled), values alike.
            a2 = torch.stack([a, b.roll(1, 0)], dim=1).contiguous()
            b2 = torch.stack([b, a.roll(2, 0)], dim=1).contiguous()
            k2 = cuda_fq.fq2_mul(a2, b2)
            p2 = cuda_fq.fq2_mul_plain(a2, b2)
            torch.cuda.synchronize()
            for name, kk, pp in (("fq_mul", k, p), ("fq2_mul", k2, p2)):
                err = int((kk.long() - pp.long()).abs().max())
                max_err[name] = max(max_err[name], err)
                if not torch.equal(kk, pp):
                    raise AssertionError(f"{name} n={n} {kind}: kernel != plain (max err {err})")
                if int(kk.abs().max()) >= bound[name]:
                    raise AssertionError(f"{name} n={n} {kind}: output limb above its bound")
            kc, k2c = k.cpu(), k2.cpu()
            for i in sample_rows(n):
                if from_limbs16(kc[i]) != va[i] * vb[i] % P:
                    raise AssertionError(f"fq_mul n={n} {kind} row {i}: wrong value")
                x0, x1 = va[i], vb[(i - 1) % n]
                y0, y1 = vb[i], va[(i - 2) % n]
                c0 = (x0 * y0 - x1 * y1) % P
                c1 = (x0 * y1 + x1 * y0) % P
                if (from_limbs16(k2c[i, 0]), from_limbs16(k2c[i, 1])) != (c0, c1):
                    raise AssertionError(f"fq2_mul n={n} {kind} row {i}: wrong value")
        log(f"[kernels] n={n}: fq_mul and fq2_mul equal their plain versions "
            f"(canonical, redundant, negative, edge); sampled values match")
    return max_err


def tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def runtime_mark() -> dict:
    """Where the flight recorder and the fallback counter stand, for
    :func:`assert_on_device`."""
    from lighthouse_tpu_torch import device_telemetry, metrics

    return {"seq": device_telemetry.FLIGHT_RECORDER.recorded_total,
            "fallback": metrics.DEVICE_HOST_FALLBACK.snapshot()}


def assert_on_device(label: str, mark: dict) -> list:
    """Fail unless every batch recorded since ``mark`` ran on the card: no
    flight record with a host fallback, no rise of any fallback counter,
    both breakers closed.  Returns the records, oldest first."""
    from lighthouse_tpu_torch import device_supervisor, device_telemetry, metrics

    rec = device_telemetry.FLIGHT_RECORDER
    records = [r for r in reversed(rec.recent(limit=rec.capacity)) if r["seq"] > mark["seq"]]
    if not records:
        raise AssertionError(f"{label}: no batch reached the flight recorder")
    fallen = [r for r in records if r["host_fallback"]]
    if fallen:
        raise AssertionError(f"{label}: batches took the host route: {fallen}")
    if metrics.DEVICE_HOST_FALLBACK.snapshot() != mark["fallback"]:
        raise AssertionError(f"{label}: host-fallback counter rose: "
                             f"{metrics.DEVICE_HOST_FALLBACK.snapshot()}")
    for op in ("bls_verify", "kzg_batch", "sha256_pairs", "tree_hash", "epoch_deltas",
               "epoch_boundary", "epoch_boundary_leak"):
        if device_supervisor.breaker_state(op) != "closed":
            raise AssertionError(f"{label}: {op} breaker is {device_supervisor.breaker_state(op)}")
    return records


def last_stages(op: str) -> dict:
    """The newest ``op`` batch's stages from the flight recorder, as
    ``build`` (setup: weights, hashing, packing, upload), ``device``
    (dispatch + wait: the program to the end of its work on the card) and
    ``verdict``."""
    from lighthouse_tpu_torch import device_telemetry

    st = device_telemetry.FLIGHT_RECORDER.recent(limit=1, op=op)[0]["stages_s"]
    return {"build": st["setup"], "device": st["dispatch"] + st["wait"],
            "verdict": st["verdict"]}


def timed_verify(label: str, sets, expect: bool) -> dict:
    from lighthouse_tpu_torch.crypto.bls import api

    mark = runtime_mark()
    t0 = time.perf_counter()
    ok = api.verify_signature_sets(sets)
    seconds = time.perf_counter() - t0
    if ok is not expect:
        raise AssertionError(f"{label}: verdict {ok}, expected {expect}")
    assert_on_device(label, mark)
    stages = last_stages("bls_verify")
    log(f"[verify] {label}: verdict {ok} in {seconds:.3f} s "
        f"(build {stages['build']:.3f} s, device {stages['device']:.3f} s, "
        f"verdict {stages['verdict']:.3f} s); "
        f"{len(sets) / seconds:.1f} sets/s end to end, "
        f"{len(sets) / stages['device']:.1f} sets/s on the device program")
    return {"seconds": seconds, "stages": stages, "sets": len(sets)}


def phase_verify(cuda_fq) -> dict:
    from lighthouse_tpu_torch.crypto.bls import api, set_backend
    from lighthouse_tpu_torch.workload import committee_sets

    t0 = time.perf_counter()
    main_sets = committee_sets(*MAIN, seed=3)
    gossip_sets = committee_sets(*GOSSIP, seed=4)
    log(f"[verify] host prep (keys, hash-to-G2, signing) for {tag(MAIN)} + {tag(GOSSIP)}: "
        f"{time.perf_counter() - t0:.1f} s")
    set_backend("torch")
    timed_verify("warm-up 2x2", committee_sets(2, 2, seed=5), True)

    # The main path: counts set to 0 just before, read just after.
    cuda_fq.reset_launch_counts()
    main = timed_verify(f"{tag(MAIN)} valid", main_sets, True)
    launches = dict(cuda_fq.LAUNCHES)
    sizes = {name: dict(c) for name, c in cuda_fq.SIZES.items()}
    rows = {name: sum(n * c for n, c in s.items()) for name, s in sizes.items()}
    max_rows = {name: max(s, default=0) for name, s in sizes.items()}
    log(f"[verify] {tag(MAIN)} kernel launches {launches}, rows {rows}, largest launch {max_rows}, "
        f"distinct launch sizes { {name: len(s) for name, s in sizes.items()} }")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    again = timed_verify(f"{tag(MAIN)} valid (second run)", main_sets, True)
    tampered = list(main_sets)
    forged = committee_sets(1, MAIN[1], seed=9)[0]
    victim = len(tampered) // 2
    tampered[victim] = api.SignatureSet.multiple_pubkeys(
        forged.signature, main_sets[victim].signing_keys, main_sets[victim].message)
    timed_verify(f"{tag(MAIN)} one tampered set", tampered, False)
    cuda_fq.reset_launch_counts()
    gossip = timed_verify(f"{tag(GOSSIP)} gossip batch", gossip_sets, True)
    log(f"[verify] {tag(GOSSIP)} kernel launches {dict(cuda_fq.LAUNCHES)}")
    return {"launches": launches, "sizes": sizes,
            "main": main, "again": again, "gossip": gossip}


def phase_parity() -> None:
    import torch

    from lighthouse_tpu_torch.crypto.bls.backends.host import _rand_scalars
    from lighthouse_tpu_torch.ops import pairing, verify
    from lighthouse_tpu_torch.workload import committee_sets

    sets = committee_sets(4, 4, seed=11)
    host_batch = verify.build_batch(sets, _rand_scalars(4, b"chip-smoke-parity"))
    t0 = time.perf_counter()
    fe_gpu, _ = verify._device_verify(*verify.batch_from_numpy(host_batch, "cuda"))
    fe_gpu = fe_gpu.cpu()
    t1 = time.perf_counter()
    fe_cpu, _ = verify._device_verify(*verify.batch_from_numpy(host_batch, "cpu"))
    t2 = time.perf_counter()
    if not torch.equal(fe_gpu, fe_cpu):
        raise AssertionError("4x4 parity: card fe != CPU fe")
    if not pairing.fe_is_one(fe_gpu):
        raise AssertionError("4x4 parity: valid batch did not verify")
    log(f"[parity] 4x4 fe equal limb for limb on cuda ({t1 - t0:.3f} s) and cpu "
        f"({t2 - t1:.3f} s); verdict True")


def kzg_inputs() -> tuple:
    """The mainnet setup, a ``Kzg`` at the default device, and KZG_BLOBS
    distinct blobs from a seed with their commitments and proofs."""
    from lighthouse_tpu_torch.crypto.kzg import BLS_MODULUS, FIELD_ELEMENTS_PER_BLOB, Kzg, TrustedSetup

    t0 = time.perf_counter()
    setup = TrustedSetup.from_json(KZG_SETUP.read_text(), validate=False)
    t1 = time.perf_counter()
    kzg = Kzg(setup)
    rng = random.Random(0xB10B)
    blobs = [b"".join((rng.getrandbits(256) % BLS_MODULUS).to_bytes(32, "big")
                      for _ in range(FIELD_ELEMENTS_PER_BLOB)) for _ in range(KZG_BLOBS)]
    commitments = [kzg.blob_to_kzg_commitment(b) for b in blobs]
    proofs = [kzg.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, commitments)]
    log(f"[kzg] mainnet setup ({setup.width} G1 points) loaded in {t1 - t0:.1f} s; "
        f"{KZG_BLOBS} blobs committed and proved on the host in {time.perf_counter() - t1:.1f} s")
    return kzg, blobs, commitments, proofs


def timed_kzg(label: str, fn, expect: bool, lanes: int) -> dict:
    """Run one KZG batch; the host stage is the time outside the device
    entry point's own stages (parsing, challenges, evaluations)."""
    mark = runtime_mark()
    t0 = time.perf_counter()
    ok = fn()
    seconds = time.perf_counter() - t0
    if ok is not expect:
        raise AssertionError(f"{label}: verdict {ok}, expected {expect}")
    assert_on_device(label, mark)
    stages = last_stages("kzg_batch")
    stages["host"] = seconds - sum(stages.values())
    log(f"[kzg] {label}: verdict {ok} in {seconds:.3f} s (host {stages['host']:.3f} s, "
        f"build {stages['build']:.3f} s, device {stages['device']:.3f} s, "
        f"verdict {stages['verdict']:.3f} s); {lanes / seconds:.1f} blobs/s end to end, "
        f"{lanes / stages['device']:.1f} blobs/s on the device program")
    return {"seconds": seconds, "stages": stages, "lanes": lanes}


def counted(cuda_fq, label: str, run) -> tuple:
    """``run()`` with the launch counts set to 0 just before and read just
    after; fails unless both kernels were launched."""
    cuda_fq.reset_launch_counts()
    out = run()
    launches = dict(cuda_fq.LAUNCHES)
    sizes = {name: dict(c) for name, c in cuda_fq.SIZES.items()}
    log(f"[kzg] {label} kernel launches {launches}, "
        f"distinct launch sizes { {name: len(s) for name, s in sizes.items()} }")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched in {label}")
    return out, {"launches": launches, "sizes": sizes}


def blob_lanes(kzg, blobs, commitments, proofs):
    """The blobs' challenges z, evaluations y and parsed points, computed
    once per blob, and a function that gives the device entry point's
    arguments for the first ``n`` blobs tiled ``reps`` times (with lane
    ``bad``'s y changed to y + 1 mod R if given), the r powers hashed from
    those lanes as ``Kzg`` hashes them."""
    from lighthouse_tpu_torch.crypto.bls.params import R
    from lighthouse_tpu_torch.crypto.kzg import blob_to_polynomial
    from lighthouse_tpu_torch.crypto.kzg.kzg import _bytes_to_g1, _g1_to_curve_point

    t0 = time.perf_counter()
    zs = [kzg.compute_challenge(b, c) for b, c in zip(blobs, commitments)]
    ys = [kzg.evaluate_polynomial_in_evaluation_form(blob_to_polynomial(b), z)
          for b, z in zip(blobs, zs)]
    c_pts = [_g1_to_curve_point(_bytes_to_g1(c)) for c in commitments]
    p_pts = [_g1_to_curve_point(_bytes_to_g1(p)) for p in proofs]
    log(f"[kzg] host prep of {len(blobs)} distinct blobs (challenges, evaluations, "
        f"parsing): {time.perf_counter() - t0:.3f} s")

    def lanes(reps: int, n: int = len(blobs), bad=None) -> tuple:
        lane_ys = ys[:n] * reps
        if bad is not None:
            lane_ys[bad] = (lane_ys[bad] + 1) % R
        lane_zs = zs[:n] * reps
        r_powers = kzg._compute_r_powers(commitments[:n] * reps, lane_zs, lane_ys,
                                         proofs[:n] * reps)
        return (c_pts[:n] * reps, p_pts[:n] * reps, r_powers, lane_zs, lane_ys,
                kzg.setup.g2_monomial[1])

    return lanes


def phase_kzg(cuda_fq, kzg, blobs, commitments, proofs, lanes) -> dict:
    import torch

    from lighthouse_tpu_torch.ops import kzg_device
    from lighthouse_tpu_torch.profile_verify import trace

    # One block's blobs through the user's entry point, at the default device.
    block, block_counts = counted(cuda_fq, f"{KZG_BLOBS} blobs", lambda: timed_kzg(
        f"{KZG_BLOBS} blobs valid",
        lambda: kzg.verify_blob_kzg_proof_batch(blobs, commitments, proofs), True, KZG_BLOBS))
    swapped = [proofs[1], proofs[0], *proofs[2:]]
    timed_kzg(f"{KZG_BLOBS} blobs, two proofs swapped",
              lambda: kzg.verify_blob_kzg_proof_batch(blobs, commitments, swapped), False, KZG_BLOBS)

    # The Deneb target: the six tiled over 32 blocks.
    reps = KZG_LANES // KZG_BLOBS
    wide, wide_counts = counted(cuda_fq, f"{KZG_LANES} lanes", lambda: timed_kzg(
        f"{KZG_LANES} lanes valid",
        lambda: kzg_device.verify_kzg_proof_batch_device(*lanes(reps)), True, KZG_LANES))
    timed_kzg(f"{KZG_LANES} lanes, one y + 1",
              lambda: kzg_device.verify_kzg_proof_batch_device(*lanes(reps, bad=KZG_LANES // 2)),
              False, KZG_LANES)

    # Where the device program's time goes: one traced run at each width.
    def device_run(host_batch):
        fe = kzg_device._device_kzg_batch(*kzg_device.batch_from_numpy(host_batch, "cuda"))
        torch.cuda.synchronize()
        return fe

    traced = {}
    for key, n_reps, timed in (("kzg6", 1, block), ("kzg192", reps, wide)):
        host_batch = kzg_device._build_kzg_batch(*lanes(n_reps),
                                                 kzg_device._bucket(n_reps * KZG_BLOBS))
        t = traced[key] = trace(lambda: device_run(host_batch), timed["stages"]["device"])
        log(f"[kzg] {timed['lanes']}-lane device program traced: {t['device_kernel_launches']} "
            f"kernel launches, device busy {t['device_busy_s']:.4f} s = "
            f"{t['device_busy_share_of_wall']:.1%} of the unprofiled device stage; Fq kernels "
            f"{t['fq_kernel_device_s']}")
        for k in t["top_kernels"][:6]:
            log(f"[kzg]   {k['device_s'] * 1e3:9.3f} ms {k['count']:7d}x  {k['name']}")
    return {"block": block, "wide": wide, "traced": traced,
            "kzg6": block_counts, "kzg192": wide_counts}


def phase_kzg_parity(lanes) -> None:
    import torch

    from lighthouse_tpu_torch.ops import kzg_device, pairing

    host_batch = kzg_device._build_kzg_batch(*lanes(1, n=2), 2)
    t0 = time.perf_counter()
    fe_gpu = kzg_device._device_kzg_batch(*kzg_device.batch_from_numpy(host_batch, "cuda")).cpu()
    t1 = time.perf_counter()
    fe_cpu = kzg_device._device_kzg_batch(*kzg_device.batch_from_numpy(host_batch, "cpu"))
    t2 = time.perf_counter()
    if not torch.equal(fe_gpu, fe_cpu):
        raise AssertionError("2-blob KZG parity: card fe != CPU fe")
    if not pairing.fe_is_one(fe_gpu):
        raise AssertionError("2-blob KZG parity: valid batch did not verify")
    log(f"[kzg parity] 2-blob fe equal limb for limb on cuda ({t1 - t0:.3f} s) and cpu "
        f"({t2 - t1:.3f} s); verdict True")


def forge(sets: list, victim: int, seed: int) -> list:
    """``sets`` with set ``victim``'s signature replaced by another
    committee's signature over the same message."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.workload import committee_sets

    out = list(sets)
    forged = committee_sets(1, len(sets[victim].signing_keys), seed=seed)[0]
    out[victim] = api.SignatureSet.multiple_pubkeys(
        forged.signature, sets[victim].signing_keys, sets[victim].message)
    return out


def phase_runtime(cuda_fq, card: str, kzg, blobs, commitments, proofs,
                  device: str = "cuda") -> dict:
    """The device runtime at full width (see the module docstring)."""
    import threading

    from lighthouse_tpu_torch import device_pipeline, device_telemetry, metrics
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ops import verify
    from lighthouse_tpu_torch.workload import committee_sets

    t0 = time.perf_counter()
    groups = [("block_import", committee_sets(*MAIN, seed=31), True)]
    groups += [("gossip_attestation", committee_sets(8, 1, seed=40 + i), True) for i in range(8)]
    groups += [("gossip_attestation", forge(committee_sets(8, 1, seed=50), 3, seed=51), False)]
    log(f"[runtime] host prep of 1 x {tag(MAIN)} + 9 x 8x1 groups: {time.perf_counter() - t0:.1f} s")

    want = [expect for _, _, expect in groups]

    def drive(label: str) -> tuple:
        """The ten groups from ten threads at once, the hash-to-G2 cache
        cold; fails unless every verdict is as expected and every batch
        ran on the card.  Returns the wall seconds and the records."""
        verify._hash_cache.clear()
        verdicts: list = [None] * len(groups)
        start = threading.Barrier(len(groups))

        def call(i: int, kind: str, sets: list) -> None:
            with device_pipeline.work_context(kind):
                start.wait()
                verdicts[i] = api.verify_signature_sets(sets, device=device)

        threads = [threading.Thread(target=call, args=(i, kind, sets), name=f"runtime-{i}")
                   for i, (kind, sets, _) in enumerate(groups)]
        mark = runtime_mark()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if verdicts != want:
            raise AssertionError(f"[runtime] {label}: verdicts {verdicts}, expected {want}")
        records = assert_on_device(f"[runtime] {label}", mark)
        if any(metrics.DEVICE_HOST_FALLBACK.snapshot().values()):
            raise AssertionError(f"[runtime] {label}: host fallbacks "
                                 f"{metrics.DEVICE_HOST_FALLBACK.snapshot()}")
        for r in records:
            log(f"[runtime]   {label}: batch seq {r['seq']} shape {r['shape']} n_groups "
                f"{r.get('n_groups')} verdict {r['verdict']} stages {r['stages_s']} "
                f"work_mix {r.get('work_mix')}")
        return wall, records

    device_pipeline.enable(device=device)
    pipe = device_pipeline.get_pipeline()
    # A block's 128 sets fill a batch alone, so a failing gossip batch never
    # re-checks the block on the host; gossip groups coalesce among
    # themselves.  The linger is pinned so that groups arriving together
    # are taken together.
    pipe.target_sets = MAIN[0]
    pipe.linger_s = RUNTIME_LINGER_S
    cuda_fq.reset_launch_counts()
    wall, records = drive("pipeline on")
    launches = dict(cuda_fq.LAUNCHES)
    snap = device_pipeline.summary()
    device_pipeline.shutdown()
    if not any(r.get("n_groups", 1) >= 2 for r in records):
        raise AssertionError(f"[runtime] no coalesced batch: {records}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched in the runtime phase")
    batches = snap["recent_batches"]
    busy = snap["builder_busy_s"] + snap["executor_busy_s"]
    log(f"[runtime] {card}: {len(groups)} groups ({sum(len(g[1]) for g in groups)} sets) "
        f"from {len(groups)} threads in {wall:.3f} s: {snap['batches_total']} batches, "
        f"n_groups {[b['n_groups'] for b in batches]}, sets {[b['n_sets'] for b in batches]}, "
        f"fill ratio {[b['fill_ratio'] for b in batches]} of target {snap['target_sets']}, "
        f"effective linger {snap['effective_linger_s']} s, linger waited "
        f"{[b['linger_s'] for b in batches]} s, group re-checks "
        f"{[b['group_rechecks'] for b in batches]}; builder busy {snap['builder_busy_s']:.3f} s, "
        f"executor busy {snap['executor_busy_s']:.3f} s, sum {busy:.3f} s = "
        f"{busy / wall:.1%} of the wall; kernel launches {launches}")
    # The same traffic with the pipeline off: each caller's own batch on
    # the direct supervised path (the supervisor's one worker per op
    # serializes the device stages; the builds run in the callers).
    wall_off, records_off = drive("pipeline off")
    log(f"[runtime] {card}: the same {len(groups)} groups with the pipeline off: "
        f"{len(records_off)} batches in {wall_off:.3f} s (pipeline on: {len(records)} "
        f"batches in {wall:.3f} s)")

    mark = runtime_mark()
    t0 = time.perf_counter()
    if kzg.verify_blob_kzg_proof_batch(blobs, commitments, proofs) is not True:
        raise AssertionError("[runtime] 6-blob KZG batch did not verify")
    kzg_s = time.perf_counter() - t0
    rec = assert_on_device("[runtime] kzg", mark)[-1]
    log(f"[runtime] {card}: {KZG_BLOBS}-blob KZG batch under the supervisor: verdict True in "
        f"{kzg_s:.3f} s, breaker {rec['breaker_state']}, stages {rec['stages_s']}")
    summary = device_telemetry.summary()
    log(f"[runtime] host fallbacks {summary['host_fallbacks']}, breakers "
        f"{[(b['op'], b['state']) for b in summary['supervisor']['breakers']]}")
    return {"wall_s": wall, "wall_off_s": wall_off, "pipeline": snap, "launches": launches,
            "kzg_s": kzg_s}


def sha_words(rng, shape) -> "np.ndarray":
    import numpy as np

    return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)


def phase_hash_kernels() -> dict:
    """Both SHA-256 kernels against their plain versions on the card, word
    for word, and against hashlib (see the module docstring)."""
    import hashlib

    import numpy as np
    import torch

    from lighthouse_tpu_torch.ops import cuda_sha, tree_hash

    rng = np.random.default_rng(0x5A256)
    max_err = {"sha256_pairs": 0, "tree_hash_subtrees": 0}

    def checked_rows(n: int) -> list:
        return (list(range(n)) if n <= HASHLIB_ALL
                else sorted(rng.choice(n, HASHLIB_ALL, replace=False).tolist()))

    for n in PAIR_NS:
        words = sha_words(rng, (n, 16))
        x = torch.from_numpy(words.view(np.int32)).cuda()
        k, p = cuda_sha.sha256_pairs(x), cuda_sha.sha256_pairs_plain(x)
        torch.cuda.synchronize()
        err = int((k.long() - p.long()).abs().max())
        max_err["sha256_pairs"] = max(max_err["sha256_pairs"], err)
        if not torch.equal(k, p):
            raise AssertionError(f"sha256_pairs n={n}: kernel != plain (max err {err})")
        digests = k.cpu().numpy().view(np.uint32).astype(">u4")
        blocks = words.astype(">u4")
        rows = checked_rows(n)
        for i in rows:
            if hashlib.sha256(blocks[i].tobytes()).digest() != digests[i].tobytes():
                raise AssertionError(f"sha256_pairs n={n} row {i}: digest != hashlib")
        log(f"[hash-kernels] sha256_pairs n={n}: kernel equals its plain version; "
            f"{len(rows)} rows equal hashlib")
    for m in SUBTREE_MS:
        leaves = sha_words(rng, (m, 32, 8))
        x = torch.from_numpy(leaves.view(np.int32)).cuda()
        p = cuda_sha.tree_hash_subtrees_plain(x)
        for threads in (None,) + cuda_sha.SUBTREE_THREADS:
            k = cuda_sha._tree_hash_subtrees_t(x, threads)
            torch.cuda.synchronize()
            for d, (kk, pp) in enumerate(zip(k, p)):
                err = int((kk.long() - pp.long()).abs().max())
                max_err["tree_hash_subtrees"] = max(max_err["tree_hash_subtrees"], err)
                if not torch.equal(kk, pp):
                    raise AssertionError(f"tree_hash_subtrees m={m} T={threads} level {d}: "
                                         f"kernel != plain")
            if threads is None:
                rows = checked_rows(m)
                golden = tree_hash._host_subtree_levels(leaves[rows])
                for d, (kk, g) in enumerate(zip(k, golden)):
                    if not np.array_equal(kk.cpu().numpy().view(np.uint32)[rows], g):
                        raise AssertionError(f"tree_hash_subtrees m={m} level {d}: != hashlib")
        log(f"[hash-kernels] tree_hash_subtrees m={m}: all five levels equal the plain "
            f"version at T = {cuda_sha.subtree_threads(m)} (the table's) and at every T of "
            f"{cuda_sha.SUBTREE_THREADS}; {len(rows)} subtrees equal hashlib")
    return max_err


def hash_records_since(mark: dict) -> list:
    """The flight records of the two hashing ops since ``mark``."""
    from lighthouse_tpu_torch import device_telemetry

    rec = device_telemetry.FLIGHT_RECORDER
    return [r for r in rec.recent(limit=rec.capacity)
            if r["seq"] > mark["seq"] and r["op"] in ("sha256_pairs", "tree_hash")]


def device_seconds(records: list) -> float:
    return sum(r.get("stages_s", {}).get("dispatch", 0.0) + r.get("stages_s", {}).get("wait", 0.0)
               for r in records)


def phase_state(card: str, device: str = "cuda") -> dict:
    """BeaconState tree hashing at mainnet width on the default device (see
    the module docstring).  The launch counts are set to 0 just before the
    device engines' first root and read just after their last."""
    from lighthouse_tpu_torch.ops import cuda_sha
    from lighthouse_tpu_torch.ops import sha256_device as sd
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.workload import append_validators, mutate_balances, random_state

    t0 = time.perf_counter()
    state, types = random_state(STATE_VALIDATORS, seed=0x57A7E)
    build_s = time.perf_counter() - t0
    log(f"[state] Deneb mainnet-preset state with {len(state.validators)} validators built "
        f"from a seed in {build_s:.2f} s")

    host_cache = dev_cache = None

    def golden(label: str) -> tuple:
        """The root with the device engines off, on the native host kernel
        (the state's host-engine cache, kept incremental across steps)."""
        nonlocal host_cache, dev_cache
        dev_cache = getattr(state, "_thc", None)
        sd.uninstall_device_hash()
        th.configure(enabled=False)
        state._thc = host_cache
        t = time.perf_counter()
        root = state.hash_tree_root()
        seconds = time.perf_counter() - t
        host_cache = state._thc
        log(f"[state] {label} golden root (host engines, native SHA) in {seconds:.2f} s")
        return root, seconds

    def device_root(label: str, mark: dict) -> dict:
        nonlocal dev_cache
        th.configure(enabled=True, device=device)
        sd.install_device_hash(device=device)
        state._thc = dev_cache
        sd.reset_routes()
        before = dict(cuda_sha.LAUNCHES)
        t = time.perf_counter()
        root = state.hash_tree_root()
        wall = time.perf_counter() - t
        dev_cache = state._thc
        records = hash_records_since(mark)
        mark["seq"] = max([mark["seq"]] + [r["seq"] for r in records])
        dev_s = device_seconds(records)
        launches = {k: v - before[k] for k, v in cuda_sha.LAUNCHES.items()}
        out = {"root": root, "wall_s": wall, "device_s": dev_s, "host_s": wall - dev_s,
               "launches": launches, "blocks": dict(sd.ROUTE_BLOCKS),
               "route_s": {k: round(v, 4) for k, v in sd.ROUTE_SECONDS.items()},
               "batches": len(records)}
        log(f"[state] {label} root on {card}: {wall:.2f} s (host {wall - dev_s:.2f} s, device "
            f"stages {dev_s:.3f} s over {len(records)} supervised batches); kernel launches "
            f"{launches}")
        log(f"[state] {label} blocks by route: card via the subtree kernel "
            f"{out['blocks'].get('device_subtree', 0)}, card via the pair kernel "
            f"{out['blocks'].get('device_pairs', 0)}, host below a threshold "
            f"{out['blocks'].get('host_below', 0)}, host above the top bucket "
            f"{out['blocks'].get('host_above', 0)}; seconds by route {out['route_s']}")
        return out

    golden_full, golden_full_s = golden("full")
    start = runtime_mark()
    mark = dict(start)
    cuda_sha.reset_launch_counts()
    full = device_root("full", mark)
    if full["root"] != golden_full:
        raise AssertionError("[state] full root on the card != host golden")
    # One slot's changes in two steps: the balance side, then the deposits.
    # Appended validators change the length of every registry-sized list,
    # so each of their trees rebuilds through the subtree kernel (as in the
    # JAX package); the dirty-path pair batches show in the balance step.
    counts = mutate_balances(state, seed=0x5107, dirty_fraction=STATE_DIRTY_FRACTION,
                             effective=STATE_EFFECTIVE)
    golden_bal, golden_bal_s = golden("after the balance changes")
    balances = device_root(f"incremental ({counts})", mark)
    if balances["root"] != golden_bal:
        raise AssertionError("[state] root after the balance changes != host golden")
    counts = append_validators(state, types, seed=0xDE90, count=STATE_APPENDED)
    golden_dep, golden_dep_s = golden("after the deposits")
    deposits = device_root(f"incremental ({counts})", mark)
    if deposits["root"] != golden_dep:
        raise AssertionError("[state] root after the deposits != host golden")
    launches = dict(cuda_sha.LAUNCHES)
    sizes = {name: dict(c) for name, c in cuda_sha.SIZES.items()}
    sd.uninstall_device_hash()
    th.configure(enabled=False)
    assert_on_device("[state]", start)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the [state] path")
    log(f"[state] {card}: full, balance-step and deposit-step roots equal the host golden; "
        f"kernel launches {launches}, launch sizes {sizes}; no host fallback, breakers closed")
    return {"launches": launches, "sizes": sizes, "build_s": build_s,
            "roots": {"full": full, "balances": balances, "deposits": deposits},
            "golden_s": {"full": golden_full_s, "balances": golden_bal_s,
                         "deposits": golden_dep_s},
            "validators": len(state.validators)}


def phase_hash_runtime(card: str, device: str = "cuda") -> dict:
    """Both pipelines on the card at once (see the module docstring)."""
    import threading

    import numpy as np

    from lighthouse_tpu_torch import device_pipeline, device_telemetry
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.workload import committee_sets

    rng = np.random.default_rng(0x4A54)
    t0 = time.perf_counter()
    th.configure(enabled=True, device=device)
    trees, targets, goldens = [], [], []
    for _ in range(HASH_THREADS):
        leaves = rng.integers(0, 256, (HASH_TREE_LEAVES, 32), dtype=np.uint8)
        tree = th.DeviceLeafTree(HASH_TREE_LEAVES)
        tree.update(leaves)
        dirty = rng.choice(HASH_TREE_LEAVES, int(HASH_TREE_LEAVES * HASH_DIRTY_FRACTION),
                           replace=False)
        mutated = leaves.copy()
        mutated[dirty] ^= 0xA5
        trees.append(tree)
        targets.append(mutated)
        goldens.append(th.golden_root(mutated, HASH_TREE_LEAVES))
    block = committee_sets(*MAIN, seed=61)
    log(f"[hash-runtime] {HASH_THREADS} trees of {HASH_TREE_LEAVES} leaves built through the "
        f"subtree kernel, their hashlib golden roots and one {tag(MAIN)} group prepared in "
        f"{time.perf_counter() - t0:.1f} s")

    device_pipeline.enable(device=device)
    hash_pipe = device_pipeline.get_hash_pipeline()
    hash_pipe.linger_s = RUNTIME_LINGER_S
    bls_pipe = device_pipeline.get_pipeline()
    bls_pipe.target_sets = MAIN[0]
    bls_pipe.linger_s = RUNTIME_LINGER_S
    roots: list = [None] * HASH_THREADS
    verdict: list = [None]
    start = threading.Barrier(HASH_THREADS + 1)

    def update(i: int) -> None:
        with device_pipeline.work_context("tree_hash"):
            start.wait()
            roots[i] = trees[i].update(targets[i])

    def verify() -> None:
        with device_pipeline.work_context("block_import"):
            start.wait()
            verdict[0] = api.verify_signature_sets(block, device=device)

    threads = [threading.Thread(target=update, args=(i,), name=f"hash-runtime-{i}")
               for i in range(HASH_THREADS)]
    threads.append(threading.Thread(target=verify, name="hash-runtime-bls"))
    mark = runtime_mark()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    snap = device_pipeline.summary()
    device_pipeline.shutdown()
    th.configure(enabled=False)
    if roots != goldens:
        raise AssertionError("[hash-runtime] a tree's root != golden_root")
    if verdict[0] is not True:
        raise AssertionError(f"[hash-runtime] {tag(MAIN)} verdict {verdict[0]}")
    assert_on_device("[hash-runtime]", mark)
    batches = snap["hash"]["recent_batches"]
    if not any(b["n_groups"] >= 2 for b in batches):
        raise AssertionError(f"[hash-runtime] no coalesced hash batch: {batches}")
    grants = snap["arbiter"]["grants"]
    if not (grants.get("sha256_pairs", 0) >= 1 and grants.get("bls_verify", 0) >= 1):
        raise AssertionError(f"[hash-runtime] arbiter grants {grants}")
    if any(b["group_rehashes"] or b["group_errors"] for b in batches):
        raise AssertionError(f"[hash-runtime] groups re-hashed or failed: {batches}")
    log(f"[hash-runtime] {card}: {HASH_THREADS} tree updates ({HASH_DIRTY_FRACTION:.0%} dirty) "
        f"and one {tag(MAIN)} verify from {len(threads)} threads in {wall:.3f} s; every root "
        f"equals golden_root, verdict True; hash batches {snap['hash']['batches_total']} "
        f"(groups {[b['n_groups'] for b in batches]}, blocks {[b['n_blocks'] for b in batches]}), "
        f"arbiter grants {grants}, waits {snap['arbiter']['wait_s']} s; host fallbacks "
        f"{device_telemetry.host_fallback_counts()}")
    return {"wall_s": wall, "hash": snap["hash"], "arbiter": snap["arbiter"]}


def counter_deltas(before: dict) -> dict:
    """Every supervisor counter series that moved since ``before``, as
    ``{"metric": {labels: delta}}``."""
    from lighthouse_tpu_torch import metrics

    out = {}
    for name, counter in SUPERVISOR_COUNTERS.items():
        moved = {",".join(f"{k}={v}" for k, v in key): value - before[name].get(key, 0.0)
                 for key, value in getattr(metrics, counter).snapshot().items()
                 if value != before[name].get(key, 0.0)}
        if moved:
            out[name] = moved
    return out


def counter_marks() -> dict:
    from lighthouse_tpu_torch import metrics

    return {name: getattr(metrics, c).snapshot() for name, c in SUPERVISOR_COUNTERS.items()}


def fault_case(label: str, run, expect, expect_deltas: dict) -> None:
    """Run one fault case; its outcome and every counter delta must be as
    expected, exactly.  ``expect`` is the verdict (or other value) the case
    returns, or the exception class it must raise.  The fault plans are
    cleared after it."""
    from lighthouse_tpu_torch import fault_injection

    before = counter_marks()
    t0 = time.perf_counter()
    try:
        out = run()
    except Exception as err:  # noqa: BLE001 — checked against ``expect`` below
        if not (isinstance(expect, type) and isinstance(err, expect)):
            raise
        out = err
    finally:
        fault_injection.clear()
    seconds = time.perf_counter() - t0
    got = counter_deltas(before)
    if isinstance(expect, type):
        if not isinstance(out, expect):
            raise AssertionError(f"[faults] {label}: returned {out!r}, "
                                 f"expected {expect.__name__} to be raised")
        shown = f"raised {type(out).__name__}: {out}"
    else:
        if out != expect or type(out) is not type(expect):
            raise AssertionError(f"[faults] {label}: returned {out!r}, expected {expect!r}")
        shown = f"returned {out!r}"
    if got != expect_deltas:
        raise AssertionError(f"[faults] {label}: counter deltas {got}, expected {expect_deltas}")
    log(f"[faults] {label}: {shown} in {seconds:.3f} s; counter deltas {got}")


def phase_faults(cuda_fq, kzg, blobs, commitments, proofs, device: str = "cuda") -> None:
    """The supervisor's routes on the card at small size (see the module
    docstring).  On the card no failure is answered by the host: a failed,
    hung or breaker-refused batch raises into the caller, so no case may
    move the host-fallback counter."""
    import threading

    from lighthouse_tpu_torch import device_supervisor as ds
    from lighthouse_tpu_torch import fault_injection as fi
    from lighthouse_tpu_torch.ops.verify import verify_signature_sets_device
    from lighthouse_tpu_torch.workload import committee_sets

    def verify(sets):
        return verify_signature_sets_device(sets, device=device)

    four, two, one = (committee_sets(n, 1, seed=70 + n) for n in (4, 2, 1))
    for sets in (four, two, one):  # first dispatch of each shape, unfaulted
        if verify(sets) is not True:
            raise AssertionError("[faults] warm-up batch did not verify")

    def split_retry():
        fi.install("device.dispatch", "error", op="bls_verify", first_n=1)
        return verify(four)

    fault_case("device.dispatch error first_n=1 on 4 x 1: split retry on the card",
               split_retry, True, {"split_retries": {"op=bls_verify,outcome=success": 1.0}})

    def hang():
        ds.SUPERVISOR.configure(deadlines={"bls_verify": HANG_DEADLINE_S})
        fi.install("device.dispatch", "hang", op="bls_verify", sleep_s=HANG_SLEEP_S, first_n=1)
        try:
            return verify(two)
        finally:
            ds.SUPERVISOR.configure(deadlines={"bls_verify": ds.DEFAULT_DEADLINES["bls_verify"]})
            # The abandoned worker wakes and finishes its batch on the
            # card; let it, before a later case installs another plan.
            for t in threading.enumerate():
                if t.name == "device-dispatch-bls_verify":
                    t.join(60.0)

    fault_case(f"hang {HANG_SLEEP_S} s past a {HANG_DEADLINE_S} s deadline on 2 x 1: "
               "watchdog, DispatchTimeout raised to the caller", hang, ds.DispatchTimeout,
               {"dispatch_timeouts": {"op=bls_verify": 1.0}})

    clock = [0.0]
    ds.set_cooldown_clock(lambda: clock[0])
    ds.SUPERVISOR.configure(config=ds.BreakerConfig(
        failure_threshold=2, open_cooldown_s=30.0, probe_successes=2))
    br = ds.SUPERVISOR.breaker("bls_verify")

    def trip():
        fi.install("device.dispatch", "error", op="bls_verify")
        raised = []
        for _ in range(2):  # 1-set batches cannot split
            try:
                verify(one)
            except fi.InjectedFault as err:
                raised.append(type(err).__name__)
        if br.state != "open":
            raise AssertionError(f"[faults] breaker {br.state} after 2 errors")
        return raised

    fault_case("device.dispatch errors to the threshold (2) on 1 x 1: each raised, OPEN",
               trip, ["InjectedFault", "InjectedFault"],
               {"split_retries": {"op=bls_verify,outcome=failure": 2.0},
                "breaker_transitions": {"op=bls_verify,to=open": 1.0}})

    def refused():
        launches = dict(cuda_fq.LAUNCHES)
        try:
            return verify(one)
        finally:
            if dict(cuda_fq.LAUNCHES) != launches:
                raise AssertionError("[faults] an OPEN breaker let the batch reach the card")

    fault_case("OPEN: RequeueWork raised, card untouched", refused, ds.RequeueWork, {})

    def recover():
        clock[0] += 31.0
        ok = verify(one)
        if br.state != "half_open":
            raise AssertionError(f"[faults] breaker {br.state} after one probe")
        ok = ok and verify(one)
        if br.state != "closed":
            raise AssertionError(f"[faults] breaker {br.state} after two probes")
        return ok

    fault_case("cooldown elapsed: two HALF_OPEN probes on the card, CLOSED", recover, True,
               {"breaker_transitions": {"op=bls_verify,to=half_open": 1.0,
                                        "op=bls_verify,to=closed": 1.0}})
    ds.SUPERVISOR.configure(config=ds.BreakerConfig.from_env())
    ds.set_cooldown_clock(None)

    def corrupt():
        fi.install("device.result", "corrupt", op="bls_verify", first_n=1)
        return verify(one)

    fault_case("device.result corrupt on 1 x 1: verdict False", corrupt, False, {})
    if verify(one) is not True:
        raise AssertionError("[faults] the batch after the corrupt one did not verify")

    def kzg_error():
        fi.install("device.dispatch", "error", op="kzg_batch")
        return kzg.verify_blob_kzg_proof_batch(blobs[:2], commitments[:2], proofs[:2])

    fault_case("kzg_batch device.dispatch error on 2 blobs: no split, raised to the caller",
               kzg_error, fi.InjectedFault, {})
    if kzg.verify_blob_kzg_proof_batch(blobs[:2], commitments[:2], proofs[:2]) is not True:
        raise AssertionError("[faults] the KZG batch after the faulted one did not verify")
    phase_hash_faults(device)
    phase_epoch_faults(device)
    phase_block_faults(device)
    for op in ("bls_verify", "kzg_batch", "sha256_pairs", "tree_hash", "epoch_boundary"):
        if ds.breaker_state(op) != "closed":
            raise AssertionError(f"[faults] the {op} breaker is left open")


def phase_hash_faults(device: str = "cuda") -> None:
    """The hashing ops' supervisor routes on the card, each with its exact
    counter deltas, none reaching the host."""
    import hashlib
    import threading

    import numpy as np

    from lighthouse_tpu_torch import device_pipeline
    from lighthouse_tpu_torch import device_supervisor as ds
    from lighthouse_tpu_torch import fault_injection as fi
    from lighthouse_tpu_torch.ops import sha256_device as sd
    from lighthouse_tpu_torch.ops import tree_hash as th

    rng = np.random.default_rng(0xFA17)
    data = rng.integers(0, 256, 1000 * 64, dtype=np.uint8).tobytes()
    digests = b"".join(hashlib.sha256(data[i:i + 64]).digest() for i in range(0, len(data), 64))
    chunks = rng.integers(0, 256, (4 * th.SUBTREE_LEAVES, 32), dtype=np.uint8)
    golden = [th._words_to_chunks(lv) for lv in th._host_subtree_levels(th._chunks_to_words(chunks))]
    th.configure(device=device)
    # first dispatch of each shape, unfaulted
    if sd.hash_pairs_device(data, device=device) != digests:
        raise AssertionError("[faults] sha256_pairs warm-up != hashlib")
    th.hash_subtree_levels(chunks)

    def levels_equal(levels) -> bool:
        return all(np.array_equal(a, b) for a, b in zip(levels, golden))

    def sha_split():
        fi.install("device.dispatch", "error", op="sha256_pairs", first_n=1)
        return sd.hash_pairs_device(data, device=device) == digests

    fault_case("sha256_pairs device.dispatch error first_n=1 on 1,000 blocks: split retry on "
               "the card, digests equal hashlib", sha_split, True,
               {"split_retries": {"op=sha256_pairs,outcome=success": 1.0}})

    def tree_split():
        fi.install("device.dispatch", "error", op="tree_hash", first_n=1)
        return levels_equal(th.hash_subtree_levels(chunks))

    fault_case("tree_hash device.dispatch error first_n=1 on 4 subtrees: split retry on the "
               "card, levels equal the golden", tree_split, True,
               {"split_retries": {"op=tree_hash,outcome=success": 1.0}})

    def tree_hang():
        ds.SUPERVISOR.configure(deadlines={"tree_hash": HANG_DEADLINE_S})
        fi.install("device.dispatch", "hang", op="tree_hash", sleep_s=HANG_SLEEP_S, first_n=1)
        try:
            return th.hash_subtree_levels(chunks)
        finally:
            ds.SUPERVISOR.configure(deadlines={"tree_hash": ds.DEFAULT_DEADLINES["tree_hash"]})
            for t in threading.enumerate():
                if t.name == "device-dispatch-tree_hash":
                    t.join(60.0)

    fault_case(f"tree_hash hang {HANG_SLEEP_S} s past a {HANG_DEADLINE_S} s deadline on 4 "
               "subtrees: watchdog, DispatchTimeout raised to the caller", tree_hang,
               ds.DispatchTimeout, {"dispatch_timeouts": {"op=tree_hash": 1.0}})

    def pipeline_error():
        device_pipeline.enable(device=device)
        pipe = device_pipeline.get_hash_pipeline()
        pipe.linger_s = RUNTIME_LINGER_S
        host_calls = []
        real_host = sd._host_hash_pairs
        sd._host_hash_pairs = lambda d: host_calls.append(len(d)) or real_host(d)
        fi.install("device.dispatch", "error", op="sha256_pairs")
        try:
            futures = [pipe.submit(data[:500 * 64]), pipe.submit(data[500 * 64:])]
            raised = []
            for fut in futures:
                try:
                    fut.result(timeout=120.0)
                except fi.InjectedFault as err:
                    raised.append(type(err).__name__)
            batch = pipe.snapshot()["recent_batches"][-1]
        finally:
            sd._host_hash_pairs = real_host
            device_pipeline.shutdown()
        if (batch["n_groups"], batch["group_rehashes"], batch["group_errors"]) != (2, 0, 2):
            raise AssertionError(f"[faults] hash pipeline batch {batch}")
        if host_calls:
            raise AssertionError(f"[faults] the host kernel re-hashed {host_calls}")
        return raised

    fault_case("sha256_pairs error on every dispatch under the hash pipeline (2 groups): the "
               "split fails, both futures raise, nothing re-hashed on the host",
               pipeline_error, ["InjectedFault", "InjectedFault"],
               {"split_retries": {"op=sha256_pairs,outcome=failure": 1.0}})
    if sd.hash_pairs_device(data, device=device) != digests:
        raise AssertionError("[faults] the sha256_pairs batch after the faults != hashlib")


# ------------------------------------------------------------ the epoch slice


def walk_reference(seeds, m: int, k: int) -> "np.ndarray":
    """The spec's compute_shuffled_index of each (slot, candidate) lane's
    start, host Python: the positions the proposer walk must end at."""
    import numpy as np

    from lighthouse_tpu_torch.consensus.shuffling import compute_shuffled_index

    return np.array([[compute_shuffled_index(c % m, m, seed, SHUFFLE_ROUNDS) for c in range(k)]
                     for seed in seeds], dtype=np.int32)


def phase_epoch_kernels() -> dict:
    """Both epoch kernels against their plain versions on the card at each
    registry bucket up to 2^20 (and one below it), and against the host:
    the shuffle against ``shuffle_list`` up to EPOCH_HOST_MAX lanes and at
    the top bucket, the walk against the scalar ``compute_shuffled_index``
    at every size."""
    import hashlib

    import numpy as np
    import torch

    from lighthouse_tpu_torch.consensus.shuffling import shuffle_list
    from lighthouse_tpu_torch.ops import cuda_epoch
    from lighthouse_tpu_torch.ops import shuffle_device as psd

    max_err = {"shuffle_round": 0, "proposer_walk": 0}
    k = psd.PROPOSER_CANDIDATES
    for n in EPOCH_NS:
        t0 = time.perf_counter()
        nb = psd._bucket(n)
        seed = hashlib.sha256(b"epoch-kernels-%d" % n).digest()
        values = np.random.default_rng(n).permutation(nb).astype(np.int32)
        pivots, digests = psd.shuffle_tables(seed, SHUFFLE_ROUNDS, n, nb)
        x, pv, dg = (torch.from_numpy(a).cuda() for a in (values, pivots, digests))
        got = cuda_epoch.shuffle_rounds(x, pv, dg, n)
        want = cuda_epoch.shuffle_rounds_plain(x, pv, dg, n)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err["shuffle_round"] = max(max_err["shuffle_round"], err)
        if not torch.equal(got, want):
            raise AssertionError(f"shuffle_round n={n}: kernel != plain (max err {err})")
        host = ""
        if n <= EPOCH_HOST_MAX or n == nb == EPOCH_NS[-1]:
            if not np.array_equal(got[:n].cpu().numpy(), shuffle_list(values[:n], seed,
                                                                       SHUFFLE_ROUNDS)):
                raise AssertionError(f"shuffle_round n={n}: != shuffle_list")
            host = "; equals shuffle_list"
        seeds = [hashlib.sha256(b"walk-%d-%d" % (n, s)).digest() for s in range(EPOCH_SLOTS)]
        seed_words, walk_pivots, _ = psd.proposer_tables(seeds, SHUFFLE_ROUNDS, n)
        sw = torch.from_numpy(seed_words.view(np.int32)).cuda()
        wp = torch.from_numpy(walk_pivots).cuda()
        walk = cuda_epoch.proposer_walk(sw, wp, k, n)
        torch.cuda.synchronize()
        ref = walk_reference(seeds, n, k)
        err = int(np.abs(walk.cpu().numpy().astype(np.int64) - ref).max())
        max_err["proposer_walk"] = max(max_err["proposer_walk"], err)
        if err:
            raise AssertionError(f"proposer_walk m={n}: != compute_shuffled_index (max err {err})")
        plain = ""
        if n in (EPOCH_NS[2], EPOCH_NS[-1]):
            for rounds in WALK_CHECK_ROUNDS:
                if rounds == SHUFFLE_ROUNDS:
                    tables = (sw, wp)
                else:
                    sw_r, wp_r, _ = psd.proposer_tables(seeds, rounds, n)
                    tables = (torch.from_numpy(sw_r.view(np.int32)).cuda(),
                              torch.from_numpy(wp_r).cuda())
                want = cuda_epoch.proposer_walk_plain(*tables, k, n)
                for look in (None,) + cuda_epoch.WALK_LOOKAHEADS:
                    got = cuda_epoch._proposer_walk_k(*tables, k, n, look)
                    if not torch.equal(got, want):
                        raise AssertionError(f"proposer_walk m={n} R={rounds} lookahead={look}: "
                                             f"kernel != plain")
            plain = (f" and its plain version at every lookahead of "
                     f"{cuda_epoch.WALK_LOOKAHEADS} and {WALK_CHECK_ROUNDS} rounds")
        log(f"[epoch-kernels] n={n} (bucket {nb}): shuffle_round x{SHUFFLE_ROUNDS} equals its "
            f"plain version{host}; proposer_walk {EPOCH_SLOTS} x {k} lanes (lookahead "
            f"{cuda_epoch.walk_lookahead()}) equals compute_shuffled_index{plain}; "
            f"{time.perf_counter() - t0:.2f} s")
    return max_err


def reference_duties(state, spec, epoch: int) -> tuple:
    """(shuffling, proposers) of ``epoch`` by the spec's host functions:
    the committee cache's numpy shuffle and the scalar proposer walk over
    the active set computed once."""
    from lighthouse_tpu_torch.consensus import helpers as h

    cache = h.CommitteeCache(state, epoch, spec)
    base = h.get_seed(state, epoch, h.DOMAIN_BEACON_PROPOSER, spec)
    proposers = [h.compute_proposer_index(state, cache.active_indices,
                                          h.hash(base + h.uint_to_bytes(slot)), spec)
                 for slot in range(epoch * spec.slots_per_epoch,
                                   (epoch + 1) * spec.slots_per_epoch)]
    return cache, proposers


def phase_epoch(card: str, device: str = "cuda", validators: int = EPOCH_VALIDATORS) -> dict:
    """The epoch boundary at mainnet width: a Deneb mainnet-preset state
    one slot before a boundary crosses it through ``process_slots`` on the
    card with the fused boundary, in both leak modes; each result equals a
    numpy-backend run of the port on a copy of the state (balances,
    inactivity, validator fields, proposers, committees, state root), with
    no host fallback.  First the staged deltas program once against the
    numpy pass; the kernels' launch counts are set to 0 just before the
    first boundary on the card and read just after the last."""
    import copy

    import numpy as np

    from lighthouse_tpu_torch import device_telemetry
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.consensus import per_slot
    from lighthouse_tpu_torch.ops import cuda_epoch
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.types.spec import mainnet_spec
    from lighthouse_tpu_torch.workload import boundary_state, set_finality

    spec = mainnet_spec()
    t0 = time.perf_counter()
    base, types = boundary_state(validators, seed=0xE90C, leak=False)
    build_s = time.perf_counter() - t0
    target = base.slot + 1
    next_epoch = target // spec.slots_per_epoch
    log(f"[epoch] Deneb mainnet-preset state with {len(base.validators)} validators one slot "
        f"before epoch {next_epoch} built from a seed in {build_s:.2f} s")
    fields = ("effective_balance", "activation_eligibility_epoch", "activation_epoch",
              "exit_epoch", "withdrawable_epoch", "slashed")
    before = {name: [getattr(v, name) for v in base.validators] for name in fields}
    staged_out = staged_deltas(base, spec, next_epoch, device)
    plans = []
    real_run = pe._run_boundary

    def recording_run(plan, *, in_leak):
        plans.append((plan, in_leak))
        return real_run(plan, in_leak=in_leak)

    pe._run_boundary = recording_run
    runs = {}
    start = runtime_mark()
    cuda_epoch.reset_launch_counts()
    try:
        for leak in (False, True):
            label = "leak" if leak else "no leak"
            t = time.perf_counter()
            card_state = copy.deepcopy(base)
            set_finality(card_state, types, leak)
            # The last mode's numpy run takes the base state itself.
            ref_state = base if leak else copy.deepcopy(base)
            set_finality(ref_state, types, leak)
            copy_s = time.perf_counter() - t

            th.configure(enabled=True, device=device)
            pe.configure(backend="device", fused_boundary=True, device=device)
            mark = runtime_mark()
            t = time.perf_counter()
            card_out = per_slot.process_slots(card_state, target, types, spec)
            card_s = time.perf_counter() - t
            records = assert_on_device(f"[epoch] {label}", mark)
            ops = [r["op"] for r in records]
            op = "epoch_boundary_leak" if leak else "epoch_boundary"
            boundary = [r for r in records if r["op"] == op]
            if len(boundary) != 1:
                raise AssertionError(f"[epoch] {label}: flight records {ops}")
            st = boundary[0]["stages_s"]
            dev_s = st["dispatch"] + st["wait"]
            hash_s = device_seconds([r for r in records if r["op"] in ("sha256_pairs", "tree_hash")])
            if pe.is_in_inactivity_leak(card_out, spec) is not leak:
                raise AssertionError(f"[epoch] {label}: leak mode is not {leak}")
            t = time.perf_counter()
            card_root = card_out.hash_tree_root()
            card_root_s = time.perf_counter() - t

            th.configure(enabled=False)
            pe.configure(backend="numpy")
            t = time.perf_counter()
            ref_out = per_slot.process_slots(ref_state, target, types, spec)
            ref_s = time.perf_counter() - t
            t = time.perf_counter()
            ref_root = ref_out.hash_tree_root()
            ref_root_s = time.perf_counter() - t

            t = time.perf_counter()
            if list(card_out.balances) != list(ref_out.balances):
                raise AssertionError(f"[epoch] {label}: balances != numpy run")
            if list(card_out.inactivity_scores) != list(ref_out.inactivity_scores):
                raise AssertionError(f"[epoch] {label}: inactivity != numpy run")
            changed = {}
            for name in fields:
                a = [getattr(v, name) for v in card_out.validators]
                if a != [getattr(v, name) for v in ref_out.validators]:
                    raise AssertionError(f"[epoch] {label}: validator {name} != numpy run")
                changed[name] = sum(x != y for x, y in zip(a, before[name]))
            cache, proposers = reference_duties(ref_out, spec, next_epoch)
            primed = h._caches(card_out)
            card_cache = primed["committees"][next_epoch]
            if not (np.array_equal(card_cache.shuffling, cache.shuffling)
                    and np.array_equal(card_cache.active_indices, cache.active_indices)
                    and card_cache.committees_per_slot == cache.committees_per_slot):
                raise AssertionError(f"[epoch] {label}: committees != numpy run")
            card_proposers = [h.get_beacon_proposer_index(card_out, spec, slot)
                              for slot in range(target, target + spec.slots_per_epoch)]
            if card_proposers != proposers:
                raise AssertionError(f"[epoch] {label}: proposers != numpy run")
            if card_root != ref_root:
                raise AssertionError(f"[epoch] {label}: state root != numpy run")
            check_s = time.perf_counter() - t
            runs[label] = {
                "card_s": card_s, "device_s": dev_s, "host_s": card_s - dev_s - hash_s,
                "hash_device_s": hash_s, "numpy_s": ref_s, "card_root_s": card_root_s,
                "numpy_root_s": ref_root_s, "copy_s": copy_s, "check_s": check_s,
                "stages_s": st, "changed": changed, "records": ops,
                "primed_proposers": len(primed.get("proposers", {})),
            }
            log(f"[epoch] {card}, {label}: process_slots across the boundary on the card "
                f"{card_s:.2f} s (boundary program {dev_s:.4f} s on the flight record: dispatch "
                f"{st['dispatch']:.4f} s, wait {st['wait']:.4f} s; tree hashing "
                f"{hash_s:.3f} s of device stages; host Python the rest), numpy-backend run "
                f"{ref_s:.2f} s; post-state roots {card_root_s:.2f} s (card) / {ref_root_s:.2f} s "
                f"(host); copies {copy_s:.2f} s, checks {check_s:.2f} s")
            log(f"[epoch] {label}: balances, inactivity, validator fields (changed {changed}), "
                f"{len(cache.shuffling)}-validator committees, {len(proposers)} proposers "
                f"({runs[label]['primed_proposers']} primed from the card) and the state root "
                f"equal the numpy run; flight records {ops}; no host fallback")
            del card_state, ref_state, card_out, ref_out
        del base
    finally:
        pe._run_boundary = real_run
        th.configure(enabled=False)
        pe.configure(backend="device", fused_boundary=True, device="cuda")
    launches = dict(cuda_epoch.LAUNCHES)
    sizes = {name: dict(c) for name, c in cuda_epoch.SIZES.items()}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the [epoch] path")
    assert_on_device("[epoch]", start)
    log(f"[epoch] kernel launches over both boundaries {launches}, launch sizes {sizes}; "
        f"duty-cache priming {device_telemetry.boundary_prime_counts()}")

    return {"validators": len(before["slashed"]), "build_s": build_s, "runs": runs,
            "launches": launches, "sizes": sizes, "plans": plans, **staged_out}


def staged_deltas(state, spec, next_epoch: int, device: str) -> dict:
    """The staged seam once: ``epoch_deltas_device`` on the card against the
    numpy pass, on ``state``'s registry as the boundary into ``next_epoch``
    sees it."""
    import numpy as np

    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.ops import epoch_device

    arrays = pe.EpochArrays(state, spec)
    n = arrays.n
    prev_part = np.asarray(state.previous_epoch_participation, dtype=np.int64)
    inactivity = np.asarray(state.inactivity_scores, dtype=np.int64)
    total = max(spec.effective_balance_increment, int(
        arrays.effective_balance[arrays.active_mask(next_epoch - 1)].sum()))
    kwargs = dict(previous_epoch=next_epoch - 2, in_leak=False,
                  base_reward_per_increment=spec.effective_balance_increment
                  * spec.base_reward_factor // spec.integer_squareroot(total),
                  total_active_balance=total,
                  quotient=spec.inactivity_penalty_quotient_bellatrix, spec=spec)
    t = time.perf_counter()
    staged = epoch_device.epoch_deltas_device(arrays, prev_part, inactivity, device=device,
                                              **kwargs)
    staged_s = time.perf_counter() - t
    t = time.perf_counter()
    golden = pe._epoch_deltas_numpy(arrays, prev_part, inactivity, **kwargs)
    numpy_s = time.perf_counter() - t
    if not all(np.array_equal(a, b) for a, b in zip(staged, golden)):
        raise AssertionError("[epoch] staged epoch_deltas_device != _epoch_deltas_numpy")
    log(f"[epoch] staged epoch_deltas_device on {n} validators: {staged_s:.4f} s on the card, "
        f"equal to the numpy pass ({numpy_s:.4f} s on the host)")
    return {"deltas_args": (arrays, prev_part, inactivity, kwargs), "staged_s": staged_s,
            "deltas_numpy_s": numpy_s}


def phase_epoch_faults(device: str = "cuda") -> None:
    """One epoch_boundary fault on the card: a ``device.dispatch`` error on
    a 4,096-validator boundary raises into the caller, the numpy composite
    never runs, no counter moves (the op is never split), and the next
    boundary on the card equals the numpy run."""
    import copy

    from lighthouse_tpu_torch import fault_injection as fi
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.consensus import per_slot
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.types.spec import mainnet_spec
    from lighthouse_tpu_torch.workload import boundary_state

    spec = mainnet_spec()
    base, types = boundary_state(EPOCH_FAULT_VALIDATORS, seed=0xFA0C, leak=False)
    target = base.slot + 1
    th.configure(enabled=False)
    host_calls = []
    real_numpy = pe._epoch_boundary_numpy

    def spy(plan, **kw):
        host_calls.append(plan.n)
        return real_numpy(plan, **kw)

    def boundary(state):
        return per_slot.process_slots(state, target, types, spec)

    pe._epoch_boundary_numpy = spy
    try:
        pe.configure(backend="device", fused_boundary=True, device=device)
        boundary(copy.deepcopy(base))  # first dispatch of the shape, unfaulted

        def faulted():
            fi.install("device.dispatch", "error", op="epoch_boundary")
            return boundary(copy.deepcopy(base))

        fault_case(f"epoch_boundary device.dispatch error on a {EPOCH_FAULT_VALIDATORS}-validator "
                   "boundary: no split, raised to the caller, no numpy answer",
                   faulted, fi.InjectedFault, {})
        if host_calls:
            raise AssertionError(f"[faults] the numpy boundary answered on the card: {host_calls}")
        after = boundary(copy.deepcopy(base)).as_ssz_bytes()
        pe.configure(backend="numpy")
        if after != boundary(copy.deepcopy(base)).as_ssz_bytes():
            raise AssertionError("[faults] the boundary after the fault != the numpy run")
    finally:
        pe._epoch_boundary_numpy = real_numpy
        pe.configure(backend="device", fused_boundary=True, device="cuda")


def phase_block(card: str, device: str = "cuda", validators: int = BLOCK_VALIDATORS) -> dict:
    """Block import at mainnet width on the default device (see the module
    docstring).  The kernels' launch counts are set to 0 just before the
    import and read just after it."""
    import copy
    import sys

    import numpy as np

    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.consensus import per_block
    from lighthouse_tpu_torch.consensus.state_transition import StateRootMismatch, state_transition
    from lighthouse_tpu_torch.crypto.bls import set_backend
    from lighthouse_tpu_torch.crypto.bls.backends import torch_backend
    from lighthouse_tpu_torch.fork_choice import ForkChoice
    from lighthouse_tpu_torch.ops import cuda_fq, cuda_sha
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.workload import (
        block_import_case,
        clone_state,
        resign,
        warm_pubkey_cache,
    )

    st_mod = sys.modules["lighthouse_tpu_torch.consensus.state_transition"]
    t0 = time.perf_counter()
    case = block_import_case(validators, seed=BLOCK_SEED)
    build_s = time.perf_counter() - t0
    pre, signed, types, spec = case.pre_state, case.signed_block, case.types, case.spec
    block = signed.message
    body = block.body
    slot = int(block.slot)
    block_root = block.hash_tree_root()
    parent_root = bytes(block.parent_root)
    att_keys = [sum(a.aggregation_bits) for a in body.attestations]
    log(f"[block] Deneb mainnet-preset state with {len(pre.validators)} validators at slot "
        f"{int(pre.slot)} and the block of slot {slot} built from a seed in {build_s:.2f} s "
        f"(host run without verification included): {len(body.attestations)} attestations "
        f"({min(att_keys)}-{max(att_keys)} keys, {sum(att_keys)} in all), sync bits "
        f"{sum(body.sync_aggregate.sync_committee_bits)}/{len(body.sync_aggregate.sync_committee_bits)}, "
        f"{len(body.proposer_slashings)} proposer slashing, {len(body.attester_slashings)} "
        f"attester slashing ({len(body.attester_slashings[0].attestation_1.attesting_indices)} "
        f"validators), {len(body.voluntary_exits)} exit, {len(body.bls_to_execution_changes)} "
        f"BLS change, {len(body.execution_payload.withdrawals)} withdrawals, "
        f"{len(body.execution_payload.transactions)} transactions, "
        f"{len(body.blob_kzg_commitments)} blob commitments, {len(body.deposits)} deposits; "
        f"{len(pre.eth1_data_votes)} eth1 votes in the state")

    t = time.perf_counter()
    keys = warm_pubkey_cache(case.keys)
    warm_keys_s = time.perf_counter() - t
    log(f"[block] pubkey cache warmed with the {keys} keys the block's signatures need, as "
        f"points in G1 by construction (a running node's validator pubkey cache; no "
        f"decompression or subgroup check) in {warm_keys_s:.2f} s, before the import")

    set_backend("torch")
    torch_backend.configure(device=device)
    th.configure(enabled=True, device=device)
    try:
        t = time.perf_counter()
        pre.hash_tree_root()
        warm_root_s = time.perf_counter() - t
        t = time.perf_counter()
        spare = clone_state(pre)
        copy_s = time.perf_counter() - t
        t = time.perf_counter()
        fc = ForkChoice(spec=spec, genesis_block_root=parent_root, genesis_state=pre)
        anchor_s = time.perf_counter() - t
        log(f"[block] the state's tree-hash cache warmed by one full root on {card} in "
            f"{warm_root_s:.2f} s (untimed beside the import); a copy for the refusals "
            f"{copy_s:.2f} s; fork choice anchored at the state in {anchor_s:.2f} s")

        # The import, its host stages timed by wrapping the callees.
        spans = {"process_slots": 0.0, "per_block": 0.0, "collect": 0.0, "verify": 0.0}

        def timed(key, fn):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    spans[key] += time.perf_counter() - t
            return run

        verifier = per_block.BlockSignatureVerifier
        wrapped = [(st_mod, "process_slots"), (st_mod, "per_block_processing"),
                   (verifier, "include_all_signatures"), (verifier, "verify")]
        real = [getattr(obj, name) for obj, name in wrapped]
        for (obj, name), fn, key in zip(wrapped, real, ("process_slots", "per_block", "collect",
                                                         "verify")):
            setattr(obj, name, timed(key, fn))
        mark = runtime_mark()
        cuda_fq.reset_launch_counts()
        cuda_sha.reset_launch_counts()
        try:
            t = time.perf_counter()
            post = state_transition(pre, signed, types, spec)
            wall = time.perf_counter() - t
        finally:
            for (obj, name), fn in zip(wrapped, real):
                setattr(obj, name, fn)
        launches = {**dict(cuda_fq.LAUNCHES), **dict(cuda_sha.LAUNCHES)}
        fq_sizes = {name: dict(c) for name, c in cuda_fq.SIZES.items()}
        sha_sizes = {name: dict(c) for name, c in cuda_sha.SIZES.items()}
        records = assert_on_device("[block]", mark)
        verifies = [r for r in records if r["op"] == "bls_verify"]
        if len(verifies) != 1:
            raise AssertionError(f"[block] {len(verifies)} bls_verify batches, expected one")
        batch = verifies[0]
        st = batch["stages_s"]
        if not all(k in st for k in ("setup", "dispatch", "wait")) or batch["verdict"] is not True:
            raise AssertionError(f"[block] the verify batch's record {batch}")
        verify_dev_s = st["dispatch"] + st["wait"]
        hashing = [r for r in records if r["op"] in ("sha256_pairs", "tree_hash")]
        hash_dev_s = device_seconds(hashing)
        for name in ("fq_mul", "fq2_mul", "sha256_pairs", "tree_hash_subtrees"):
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"{name} was not launched during the block import")
        host = {"process_slots": spans["process_slots"], "collect": spans["collect"],
                "verify_setup": st["setup"],
                "operations": spans["per_block"] - spans["collect"] - spans["verify"],
                "root": wall - spans["process_slots"] - spans["per_block"]}
        log(f"[block] {card}: state_transition with VERIFY_BULK imported the block in "
            f"{wall:.3f} s; host: process_slots {host['process_slots']:.3f} s (its root "
            f"included), signature-set collection {host['collect']:.3f} s, the verify's setup "
            f"{host['verify_setup']:.3f} s, operations {host['operations']:.3f} s, the post-block "
            f"root {host['root']:.3f} s; device: the verify {verify_dev_s:.3f} s (dispatch "
            f"{st['dispatch']:.3f} s, wait {st['wait']:.3f} s, verdict {st['verdict']:.3f} s), "
            f"tree hashing {hash_dev_s:.3f} s over {len(hashing)} batches")
        log(f"[block] the verify: one supervised bls_verify batch on the card, bucket "
            f"{batch['shape']} ({batch['n_live']} sets), no host fallback, breakers closed; "
            f"kernel launches {launches}")

        # The host run's state: the root, the balances, the participation
        # flags and every field of every validator.
        t = time.perf_counter()
        ref = case.host_state
        if post.hash_tree_root() != bytes(block.state_root):
            raise AssertionError("[block] post-state root != the block's")
        if list(post.balances) != list(ref.balances):
            raise AssertionError("[block] balances != the host run's")
        for field in ("previous_epoch_participation", "current_epoch_participation"):
            if list(getattr(post, field)) != list(getattr(ref, field)):
                raise AssertionError(f"[block] {field} != the host run's")
        if len(post.validators) != len(ref.validators) or not all(
                a == b for a, b in zip(post.validators, ref.validators)):
            raise AssertionError("[block] a validator != the host run's")
        check_s = time.perf_counter() - t
        log(f"[block] the post-state's root is the block's (the host run's); its balances, "
            f"participation flags and the fields of its {len(post.validators)} validators "
            f"equal the host run's (checked in {check_s:.2f} s)")

        # Fork choice takes the block and its attestations.
        t = time.perf_counter()
        fc.on_block(current_slot=slot, block=block, block_root=block_root, state=post)
        attesters = []
        for att in body.attestations:
            indexed = h.get_indexed_attestation(post, att, types, spec)
            attesters.append(np.asarray(indexed.attesting_indices, dtype=np.int64))
            fc.on_attestation(
                current_slot=slot, attestation_slot=int(att.data.slot),
                attesting_indices=indexed.attesting_indices,
                beacon_block_root=bytes(att.data.beacon_block_root),
                target_epoch=int(att.data.target.epoch),
                target_root=bytes(att.data.target.root), is_from_block=True)
        head = fc.get_head(slot)
        fc_s = time.perf_counter() - t
        unique = np.unique(np.concatenate(attesters))
        eff = np.fromiter((post.validators[int(i)].effective_balance for i in unique),
                          dtype=np.int64, count=unique.size)
        weight = fc.proto.nodes[fc.proto.indices[parent_root]].weight
        if head != block_root:
            raise AssertionError("[block] fork choice's head is not the block")
        if weight != int(eff.sum()):
            raise AssertionError(f"[block] the anchor's weight {weight} != {int(eff.sum())}, the "
                                 "unique attesters' effective balances")
        log(f"[block] fork choice: on_block, {len(body.attestations)} on_attestation and "
            f"get_head in {fc_s:.3f} s; the head is the block; the anchor's weight {weight} "
            f"gwei equals the {unique.size} unique attesters' effective balances (numpy sum)")

        # Refusals, on the copy of the pre-state.
        message = copy.deepcopy(block)
        atts = message.body.attestations
        atts[0].signature, atts[1].signature = bytes(atts[1].signature), bytes(atts[0].signature)
        mark = runtime_mark()
        t = time.perf_counter()
        try:
            state_transition(spare, resign(case, message), types, spec)
        except per_block.BlockProcessingError as err:
            if str(err) != "bulk signature verification failed":
                raise
        else:
            raise AssertionError("[block] a swapped attestation signature was accepted")
        tampered_s = time.perf_counter() - t
        refused = [r for r in assert_on_device("[block] tampered", mark)
                   if r["op"] == "bls_verify"]
        if len(refused) != 1 or refused[0]["verdict"] is not False:
            raise AssertionError(f"[block] the tampered block's verify records {refused}")
        message = copy.deepcopy(block)
        root = bytearray(bytes(message.state_root))
        root[-1] ^= 0x01
        message.state_root = bytes(root)
        t = time.perf_counter()
        try:
            state_transition(spare, resign(case, message), types, spec)
        except StateRootMismatch:
            pass
        else:
            raise AssertionError("[block] a wrong state root was accepted")
        wrong_root_s = time.perf_counter() - t
        log(f"[block] refused on {card}: two attestation signatures swapped (re-signed by the "
            f"proposer): BlockProcessingError('bulk signature verification failed') in "
            f"{tampered_s:.2f} s, its batch's verdict False on the card; a state root off by "
            f"one byte (re-signed): StateRootMismatch in {wrong_root_s:.2f} s")
    finally:
        th.configure(enabled=False)
        torch_backend.reset_for_tests()
    return {"validators": len(pre.validators), "build_s": build_s, "warm_keys_s": warm_keys_s,
            "warm_root_s": warm_root_s, "wall_s": wall, "host_s": host,
            "verify_device_s": verify_dev_s, "hash_device_s": hash_dev_s,
            "stages_s": st, "bucket": batch["shape"], "sets": batch["n_live"],
            "launches": launches, "fq_sizes": fq_sizes, "sha_sizes": sha_sizes,
            "fork_choice_s": fc_s, "anchor_s": anchor_s, "tampered_s": tampered_s,
            "wrong_root_s": wrong_root_s}


def phase_block_faults(device: str = "cuda") -> None:
    """One bls_verify fault on the block path: a ``device.dispatch`` error
    on the verify batch of a BLOCK_FAULT_VALIDATORS-validator block import
    (``workload.block_import_case``): one split retry, both halves on the
    card, the transition succeeds with the block's root, no host fallback."""
    import copy

    from lighthouse_tpu_torch import fault_injection as fi
    from lighthouse_tpu_torch.consensus.state_transition import state_transition
    from lighthouse_tpu_torch.crypto.bls import set_backend
    from lighthouse_tpu_torch.crypto.bls.backends import torch_backend
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.ops import verify
    from lighthouse_tpu_torch.workload import block_import_case, warm_pubkey_cache

    case = block_import_case(BLOCK_FAULT_VALIDATORS, seed=BLOCK_SEED + 1)
    warm_pubkey_cache(case.keys)
    set_backend("torch")
    torch_backend.configure(device=device)
    th.configure(enabled=False)
    halves = []
    real_subset = verify._device_verify_subset

    def subset(sets, seed, dev):
        halves.append((len(sets), dev.type))
        return real_subset(sets, seed, dev)

    verify._device_verify_subset = subset
    try:
        def faulted():
            fi.install("device.dispatch", "error", op="bls_verify", first_n=1)
            mark = runtime_mark()
            post = state_transition(copy.deepcopy(case.pre_state), case.signed_block,
                                    case.types, case.spec)
            assert_on_device("[faults] block", mark)
            return post.hash_tree_root() == bytes(case.signed_block.message.state_root)

        fault_case(f"device.dispatch error first_n=1 on a {BLOCK_FAULT_VALIDATORS}-validator "
                   "block's verify batch: split retry on the card, the block imports with "
                   "its root", faulted, True,
                   {"split_retries": {"op=bls_verify,outcome=success": 1.0}})
    finally:
        verify._device_verify_subset = real_subset
        torch_backend.reset_for_tests()
    n_sets = len(case.signed_block.message.body.attestations) + 9
    if sorted(halves) != sorted([(n_sets // 2, device), (n_sets - n_sets // 2, device)]):
        raise AssertionError(f"[faults] the block batch's halves {halves}")
    log(f"[faults] the block batch's halves {halves} ran on the {device} device")


def walk_sweep(seed_words, pivots, k: int, m: int, bound_ms: float) -> dict:
    """proposer_walk at every lookahead on the (S, R) tables, in turns, and
    each lookahead's latency floor: one lane alone, so each of its
    ceil(R / lookahead) steps is one warp's dependent chain of compression
    rounds on an otherwise idle card."""
    from lighthouse_tpu_torch.ops import cuda_epoch

    s, rounds = pivots.shape
    looks = cuda_epoch.WALK_LOOKAHEADS
    walk = in_turns({look: (lambda look=look: cuda_epoch._proposer_walk_k(
        seed_words, pivots, k, m, look)) for look in looks})
    floor = in_turns({look: (lambda look=look: cuda_epoch._proposer_walk_k(
        seed_words[:1].contiguous(), pivots[:1].contiguous(), 1, m, look))
        for look in looks})
    default = cuda_epoch.walk_lookahead()
    log(f"[timing] proposer_walk at {s} x {k} lanes x {rounds} rounds by lookahead: "
        + "; ".join(f"{look}: {mean(walk[look]):.4f} ms ({walk[look][0]:.4f}/{walk[look][1]:.4f}), "
                    f"one lane {mean(floor[look]):.4f} ms ({-(-rounds // look)} steps, "
                    f"{mean(floor[look]) / -(-rounds // look) * 1e3:.3f} us a step)"
                    for look in looks)
        + f"; the default {default}; bound {bound_ms:.4f} ms, the default "
        f"{bound_ms / mean(walk[default]):.1%} of it; the earlier design "
        f"{EARLIER_MS['proposer_walk']['ms']} ms (PERF.md, not measured here)")
    return {"lookahead": default,
            "ms_by_lookahead": {str(look): list(v) for look, v in walk.items()},
            "floor_ms_by_lookahead": {str(look): list(v) for look, v in floor.items()}}


def phase_epoch_timing(epoch_out: dict, max_err: dict, clock_mhz: float,
                       device: str = "cuda") -> tuple:
    """Each epoch kernel at its largest launch of the [epoch] run (device
    time of graph replays), beside its bound and its plain version; the
    two PyTorch programs (deltas, the fused boundary) at 2^20 the same way,
    the boundary also with the kernels' plain versions, and one boundary
    under torch.profiler for its kernel launches and device busy time.
    Returns (kernel rows, program rows)."""
    import numpy as np
    import torch

    from lighthouse_tpu_torch.bench_kernels import graph_ms
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.ops import cuda_epoch, epoch_device
    from lighthouse_tpu_torch.ops import shuffle_device as psd
    from lighthouse_tpu_torch.profile_verify import trace

    def profiled(run, wall_s: float) -> dict:
        """``trace`` of one ``run()``; a profiler that records no device
        kernel leaves the launch count and busy time not measured."""
        try:
            return trace(run, wall_s)
        except RuntimeError as err:
            log(f"[timing] torch.profiler: {err}; launches and busy time not measured")
            return {"device_kernel_launches": None, "device_busy_s": None, "top_kernels": []}

    ops_per_ms = INT_OPS_PER_CLK_PER_SM * SMS * clock_mhz * 1e3
    dev = torch.device(device)
    plan, leak = epoch_out["plans"][0]
    args, nb = psd.boundary_inputs(plan, dev)
    m = plan.m
    (values, sh_pivots, sh_digests, seed_words, prop_pivots) = (args[10], args[11], args[12],
                                                                 args[13], args[14])
    k = psd.PROPOSER_CANDIDATES

    def bound(ops: float, nbytes: float) -> tuple:
        ops_ms, bytes_ms = ops / ops_per_ms, nbytes / HBM_BYTES_PER_S * 1e3
        return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"

    rows = []
    # shuffle_round: one launch of the 90, at the [epoch] bucket.
    one = (sh_pivots[:1].contiguous(), sh_digests[:1].contiguous())
    ms = graph_ms(lambda: cuda_epoch.shuffle_rounds(values, *one, m))
    plain_ms = graph_ms(lambda: cuda_epoch.shuffle_rounds_plain(values, *one, m), reps=3)
    shuffle_ms = graph_ms(lambda: cuda_epoch.shuffle_rounds(values, sh_pivots, sh_digests, m),
                          reps=3)
    shuffle_plain_ms = graph_ms(
        lambda: cuda_epoch.shuffle_rounds_plain(values, sh_pivots, sh_digests, m),
        reps=1, rounds=2)
    row_bytes = sh_digests.shape[1]
    b_ms, b_by = bound(8 * nb, 8 * nb + row_bytes + 4)
    whole_b_ms, _ = bound(8 * nb * SHUFFLE_ROUNDS, 8 * nb + row_bytes * SHUFFLE_ROUNDS)
    log(f"[timing] shuffle_round at {nb} lanes: kernel {ms:.4f} ms a round, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound; the {SHUFFLE_ROUNDS}-round "
        f"shuffle {shuffle_ms:.4f} ms (plain {shuffle_plain_ms:.4f} ms), "
        f"{SHUFFLE_ROUNDS} x the round bound {b_ms * SHUFFLE_ROUNDS:.4f} ms, one-pass bound "
        f"{whole_b_ms:.4f} ms")
    rows.append({"name": "shuffle_round", "route": "cuda", "source": SHUFFLE_SOURCE,
                 "replaces": EPOCH_KERNELS["shuffle_round"]["replaces"],
                 "launches": epoch_out["launches"]["shuffle_round"],
                 "max_abs_err": max_err["shuffle_round"], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "rows": nb,
                 "shuffle_ms": shuffle_ms, "shuffle_plain_ms": shuffle_plain_ms,
                 "shuffle_bound_ms": b_ms * SHUFFLE_ROUNDS, "shuffle_one_pass_bound_ms": whole_b_ms,
                 "launches_per_boundary": epoch_out["launches"]["shuffle_round"]
                 / len(epoch_out["plans"])})
    # proposer_walk: the [epoch] launch (32 slots x 64 candidates x 90 rounds).
    s = seed_words.shape[0]
    ms = graph_ms(lambda: cuda_epoch.proposer_walk(seed_words, prop_pivots, k, m))
    plain_ms = graph_ms(lambda: cuda_epoch.proposer_walk_plain(seed_words, prop_pivots, k, m),
                        reps=1, rounds=2)
    b_ms, b_by = bound(s * k * SHUFFLE_ROUNDS * WALK_OPS_PER_ROUND + s * WALK_OPS_PER_SLOT,
                       s * 32 + s * SHUFFLE_ROUNDS * 4 + s * k * 4)
    log(f"[timing] proposer_walk at {s} x {k} lanes x {SHUFFLE_ROUNDS} rounds: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; SM clock "
        f"{clock_mhz:.0f} MHz), {b_ms / ms:.1%} of bound ({s * k} lanes cannot fill the card)")
    row = {"name": "proposer_walk", "route": "cuda", "source": SHUFFLE_SOURCE,
           "replaces": EPOCH_KERNELS["proposer_walk"]["replaces"],
           "launches": epoch_out["launches"]["proposer_walk"],
           "max_abs_err": max_err["proposer_walk"], "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "rows": s * k,
           "launches_per_boundary": epoch_out["launches"]["proposer_walk"]
           / len(epoch_out["plans"])}
    row.update(walk_sweep(seed_words, prop_pivots, k, m, b_ms))
    rows.append(row)

    # The PyTorch programs at 2^20.
    programs = {}
    boundary_ms = graph_ms(lambda: psd._boundary_kernel(*args, in_leak=leak), reps=2, rounds=3)
    real = (cuda_epoch.shuffle_rounds, cuda_epoch.proposer_walk)
    cuda_epoch.shuffle_rounds = cuda_epoch.shuffle_rounds_plain
    cuda_epoch.proposer_walk = cuda_epoch.proposer_walk_plain
    try:
        boundary_plain_ms = graph_ms(lambda: psd._boundary_kernel(*args, in_leak=leak),
                                     reps=1, rounds=2)
    finally:
        cuda_epoch.shuffle_rounds, cuda_epoch.proposer_walk = real
    t = time.perf_counter()
    pe._epoch_boundary_numpy(plan, in_leak=leak)
    boundary_numpy_s = time.perf_counter() - t
    t = time.perf_counter()
    psd._boundary_kernel(*args, in_leak=leak)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    prof = profiled(lambda: (psd._boundary_kernel(*args, in_leak=leak), torch.cuda.synchronize()),
                    wall_s)
    # Bytes: 9 int64 and 1 bool batched inputs, active_idx, the shuffle and
    # walk tables; 3 int64, 3 bool and the int32 shuffling out.
    b_bytes = nb * (9 * 8 + 1 + 4) + sum(int(a.numel() * a.element_size()) for a in args[11:16]) \
        + nb * (3 * 8 + 3 + 4)
    b_ms, b_by = bound(s * k * SHUFFLE_ROUNDS * WALK_OPS_PER_ROUND + s * WALK_OPS_PER_SLOT,
                       b_bytes)
    programs["_boundary_kernel"] = {
        "replaces": "lighthouse_tpu/ops/shuffle_device.py:192", "rows": nb, "ms": boundary_ms,
        "plain_kernels_ms": boundary_plain_ms, "numpy_host_s": boundary_numpy_s,
        "bound_ms": b_ms, "bound_by": b_by, "launches_per_boundary": 1,
        "device_kernel_launches": prof["device_kernel_launches"],
        "device_busy_s": prof["device_busy_s"], "wall_s": wall_s,
        "top_kernels": prof["top_kernels"][:6]}
    log(f"[timing] _boundary_kernel at {nb} validators ({'leak' if leak else 'no leak'}): "
        f"{boundary_ms:.4f} ms (graph replay), with the kernels' plain versions "
        f"{boundary_plain_ms:.4f} ms, numpy composite {boundary_numpy_s:.3f} s on the host; "
        f"bound {b_ms:.4f} ms ({b_by}), {b_ms / boundary_ms:.1%} of bound; "
        f"{prof['device_kernel_launches']} kernel launches, device busy "
        f"{(prof['device_busy_s'] or 0.0) * 1e3:.3f} ms of a {wall_s * 1e3:.3f} ms eager call; top "
        f"{[(k_['name'][:40], k_['count']) for k_ in prof['top_kernels'][:6]]}")
    arrays, prev_part, inactivity, kwargs = epoch_out["deltas_args"]
    n = arrays.n
    dnb = epoch_device._bucket(n)
    dev_in = [torch.from_numpy(epoch_device.grow_rows(np.asarray(a), dnb, f)).to(dev)
              for a, f in zip((arrays.effective_balance, arrays.activation_epoch,
                               arrays.exit_epoch, arrays.withdrawable_epoch, arrays.slashed,
                               prev_part, inactivity), epoch_device._PAD_FILLS)]
    spec = kwargs["spec"]
    scalars = (kwargs["previous_epoch"], kwargs["base_reward_per_increment"],
               kwargs["total_active_balance"], spec.effective_balance_increment,
               spec.inactivity_score_bias, spec.inactivity_score_recovery_rate, kwargs["quotient"])
    deltas_ms = graph_ms(lambda: epoch_device._deltas_kernel(*dev_in, *scalars, in_leak=False),
                         reps=3, rounds=3)
    t = time.perf_counter()
    epoch_device._deltas_kernel(*dev_in, *scalars, in_leak=False)
    torch.cuda.synchronize()
    d_wall = time.perf_counter() - t
    dprof = profiled(lambda: (epoch_device._deltas_kernel(*dev_in, *scalars, in_leak=False),
                              torch.cuda.synchronize()), d_wall)
    d_ms, d_by = bound(0, dnb * (6 * 8 + 1 + 2 * 8))
    programs["_deltas_kernel"] = {
        "replaces": "lighthouse_tpu/ops/epoch_device.py:128", "rows": dnb, "ms": deltas_ms,
        "numpy_host_s": epoch_out["deltas_numpy_s"], "bound_ms": d_ms, "bound_by": d_by,
        "launches_per_boundary": 1, "device_kernel_launches": dprof["device_kernel_launches"],
        "device_busy_s": dprof["device_busy_s"], "wall_s": d_wall}
    log(f"[timing] _deltas_kernel at {dnb} validators: {deltas_ms:.4f} ms (graph replay), "
        f"numpy pass {epoch_out['deltas_numpy_s']:.3f} s on the host; bound {d_ms:.4f} ms "
        f"(bytes), {d_ms / deltas_ms:.1%} of bound; {dprof['device_kernel_launches']} kernel "
        f"launches (the fused boundary runs this body too; the staged seam runs it alone)")
    return rows, programs


def phase_timing(cuda_fq, verify_out: dict, kzg_out: dict, block_out: dict, max_err: dict,
                 clock_mhz: float) -> list:
    import torch

    from lighthouse_tpu_torch.bench_kernels import OPS, graph_ms, operands, ops_per_ms, time_library

    lib, _ = cuda_fq.library(torch.device("cuda"))
    timed = time_library(lib, verify_out["sizes"], clock_mhz)
    per_kzg = {key: time_library(lib, kzg_out[key]["sizes"], clock_mhz) for key in ("kzg6", "kzg192")}
    per_block = time_library(lib, block_out["fq_sizes"], clock_mhz)
    out = []
    for name, spec in KERNELS.items():
        t = timed[name]
        n, ms = t["at_max"]
        a, b = operands(name, n, seed=1)
        plain = getattr(cuda_fq, f"{name}_plain")
        plain_ms = graph_ms(lambda: plain(a, b), reps=3)
        ops_ms = n * OPS[name] / ops_per_ms(clock_mhz)
        bytes_ms = n * spec["bytes"] / HBM_BYTES_PER_S * 1e3
        mean_n, mean_ms = t["at_mean"]
        log(f"[timing] {name} at n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f}, bytes {bytes_ms:.4f}, "
            f"SM clock {clock_mhz:.0f} MHz), {max(ops_ms, bytes_ms) / ms:.1%} of bound; "
            f"at the mean launch n={mean_n}: {mean_ms:.4f} ms")
        log(f"[timing] {name} per {tag(MAIN)} verify: {t['verify_ms']:.4f} ms over "
            f"{t['launches']} launches of {len(t['ms_by_size'])} sizes, bound "
            f"{t['verify_bound_ms']:.4f} ms ({t['verify_bound_ms'] / t['verify_ms']:.1%})")
        row = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": spec["replaces"],
            "launches": verify_out["launches"][name],
            "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "rows": n, "mean_rows": t["mean_rows"], "mean_ms": mean_ms,
            "verify_ms": t["verify_ms"], "verify_bound_ms": t["verify_bound_ms"],
        }
        for key, label in (("kzg6", f"{KZG_BLOBS}-blob"), ("kzg192", f"{KZG_LANES}-lane")):
            k = per_kzg[key][name]
            log(f"[timing] {name} per {label} KZG batch: {k['verify_ms']:.4f} ms over "
                f"{k['launches']} launches of {len(k['ms_by_size'])} sizes (largest "
                f"{k['at_max'][0]} rows), bound {k['verify_bound_ms']:.4f} ms "
                f"({k['verify_bound_ms'] / k['verify_ms']:.1%})")
            row.update({f"{key}_launches": kzg_out[key]["launches"][name],
                        f"{key}_ms": k["verify_ms"], f"{key}_bound_ms": k["verify_bound_ms"]})
        k = per_block[name]
        log(f"[timing] {name} per block import ({block_out['bucket']} verify batch): "
            f"{k['verify_ms']:.4f} ms over {k['launches']} launches of {len(k['ms_by_size'])} "
            f"sizes (largest {k['at_max'][0]} rows), bound {k['verify_bound_ms']:.4f} ms "
            f"({k['verify_bound_ms'] / k['verify_ms']:.1%})")
        row.update({"block_launches": block_out["launches"][name], "block_ms": k["verify_ms"],
                    "block_bound_ms": k["verify_bound_ms"]})
        out.append(row)
    return out


def in_turns(variants: dict, **kw) -> dict:
    """Device ms of each ``variants[name]()`` (graph replay), timed twice in
    turns, forward then backward, in one call on one card: {name: (first,
    second)}."""
    from lighthouse_tpu_torch.bench_kernels import graph_ms

    names = list(variants)
    out = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            out[name].append(graph_ms(variants[name], **kw))
    return {name: tuple(v) for name, v in out.items()}


def mean(pair) -> float:
    return sum(pair) / len(pair)


def subtree_sweep(state_out: dict, bound) -> dict:
    """tree_hash_subtrees at every T of the kernel and at the table's
    choice, at each size the [state] run launched (the caller's buckets)
    and the top bucket, in turns; the sum over the [state] run's launches
    at each T."""
    import numpy as np
    import torch

    from lighthouse_tpu_torch.ops import cuda_sha

    rng = np.random.default_rng(0x7E)
    sizes = state_out["sizes"]["tree_hash_subtrees"]
    by_t = {t: {} for t in ("table",) + cuda_sha.SUBTREE_THREADS}
    for m in sorted(set(sizes) | {SUBTREE_MS[-1]}):
        y = torch.from_numpy(sha_words(rng, (m, 32, 8)).view(np.int32)).cuda()
        times = in_turns({t: (lambda t=t: cuda_sha._tree_hash_subtrees_t(
            y, None if t == "table" else t)) for t in by_t})
        for t, pair in times.items():
            by_t[t][m] = pair
        chosen = cuda_sha.subtree_threads(m)
        fastest = min(cuda_sha.SUBTREE_THREADS, key=lambda t: mean(times[t]))
        earlier = EARLIER_MS["tree_hash_subtrees"]["by_size"].get(m)
        log(f"[timing] tree_hash_subtrees at m={m}: "
            + ", ".join(f"T={t} {mean(p):.4f} ms ({p[0]:.4f}/{p[1]:.4f})"
                        for t, p in times.items())
            + f"; the table's T={chosen}, the fastest T={fastest}; bound {bound(m)[0]:.4f} ms, "
            f"the table's {bound(m)[0] / mean(times['table']):.1%} of it; the earlier design "
            + (f"{earlier} ms (PERF.md, not measured here)" if earlier is not None
               else "not recorded"))
    state_sums = {str(t): sum(mean(by_t[t][m]) * c for m, c in sizes.items()) for t in by_t}
    log(f"[timing] tree_hash_subtrees over the [state] run's "
        f"{sum(sizes.values())} launches: "
        + ", ".join(f"T={t} {v:.4f} ms" for t, v in state_sums.items())
        + f"; the earlier design {EARLIER_MS['tree_hash_subtrees']['state']} ms (PERF.md, "
        "not measured here)")
    return {"ms_by_threads": {str(t): {str(m): list(p) for m, p in v.items()}
                              for t, v in by_t.items()},
            "state_ms_by_threads": state_sums}


def phase_hash_timing(state_out: dict, block_out: dict, max_err: dict, clock_mhz: float) -> list:
    """Each SHA-256 kernel at its top bucket and at every launch size of the
    [state] run and of the [block] import (device times replayed from a
    CUDA graph), beside its bound and its plain version, and the native
    host kernel's rate."""
    import numpy as np
    import torch

    from lighthouse_tpu_torch.bench_kernels import graph_ms
    from lighthouse_tpu_torch.ops import cuda_sha
    from lighthouse_tpu_torch.types import ssz

    ops_per_ms = INT_OPS_PER_CLK_PER_SM * SMS * clock_mhz * 1e3
    rng = np.random.default_rng(0x71)
    inputs = {
        "sha256_pairs": lambda n: torch.from_numpy(sha_words(rng, (n, 16)).view(np.int32)).cuda(),
        "tree_hash_subtrees": lambda n: torch.from_numpy(
            sha_words(rng, (n, 32, 8)).view(np.int32)).cuda(),
    }
    top = {"sha256_pairs": PAIR_NS[-1], "tree_hash_subtrees": SUBTREE_MS[-1]}

    def bound(name: str, n: int) -> tuple:
        spec = SHA_KERNELS[name]
        ops_ms = n * spec["ops"] / ops_per_ms
        bytes_ms = n * spec["bytes"] / HBM_BYTES_PER_S * 1e3
        return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"

    # The host kernel the routing thresholds weigh the card against.
    blocks = top["sha256_pairs"]
    data = rng.integers(0, 256, blocks * 64, dtype=np.uint8).tobytes()
    ssz._hash_pairs(data)
    t0 = time.perf_counter()
    ssz._hash_pairs(data)
    host_rate = blocks / (time.perf_counter() - t0)
    log(f"[timing] native host pair hasher ({ssz._hash_pairs.__name__}): "
        f"{host_rate:.0f} blocks/s on {blocks} blocks")

    out = []
    roots = len(state_out["roots"])
    for name, spec in SHA_KERNELS.items():
        wrapper = getattr(cuda_sha, name)
        plain = getattr(cuda_sha, f"{name}_plain")
        n = top[name]
        x = inputs[name](n)
        ms = graph_ms(lambda: wrapper(x))
        plain_ms = graph_ms(lambda: plain(x), reps=3, rounds=2)
        bound_ms, bound_by = bound(name, n)
        sizes = state_out["sizes"][name]
        by_size, plain_by_size = {}, {}
        for m in sorted(sizes):
            y = inputs[name](m)
            got, want = wrapper(y), plain(y)
            if not all(torch.equal(a, b) for a, b in zip(
                    got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,))):
                raise AssertionError(f"{name} at the [state] size {m}: kernel != plain")
            by_size[m] = graph_ms(lambda: wrapper(y))
            plain_by_size[m] = graph_ms(lambda: plain(y), reps=3, rounds=2)
        block_sizes = block_out["sha_sizes"][name]
        block_by_size = {m: by_size[m] for m in block_sizes if m in by_size}
        for m in sorted(set(block_sizes) - set(block_by_size)):
            y = inputs[name](m)
            got, want = wrapper(y), plain(y)
            if not all(torch.equal(a, b) for a, b in zip(
                    got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,))):
                raise AssertionError(f"{name} at the [block] size {m}: kernel != plain")
            block_by_size[m] = graph_ms(lambda: wrapper(y))
        block_ms = sum(block_by_size[m] * c for m, c in block_sizes.items())
        block_bound_ms = sum(bound(name, m)[0] * c for m, c in block_sizes.items())
        state_ms = sum(by_size[m] * c for m, c in sizes.items())
        state_plain_ms = sum(plain_by_size[m] * c for m, c in sizes.items())
        state_bound_ms = sum(bound(name, m)[0] * c for m, c in sizes.items())
        launches = state_out["launches"][name]
        log(f"[timing] {name} at its top bucket n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; SM clock {clock_mhz:.0f} MHz), "
            f"{bound_ms / ms:.1%} of bound")
        log(f"[timing] {name} over the [state] run's {launches} launches ({roots} roots, "
            f"{launches / roots:.1f} a root; sizes {dict(sorted(sizes.items()))}): "
            f"{state_ms:.4f} ms, bound {state_bound_ms:.4f} ms "
            f"({state_bound_ms / state_ms:.1%}), plain {state_plain_ms:.4f} ms; equal to the "
            f"plain version at each size; per size kernel "
            f"{ {m: round(t, 4) for m, t in by_size.items()} }, plain "
            f"{ {m: round(t, 4) for m, t in plain_by_size.items()} }")
        log(f"[timing] {name} per block import: {block_ms:.4f} ms over "
            f"{block_out['launches'][name]} launches (sizes {dict(sorted(block_sizes.items()))}), "
            f"bound {block_bound_ms:.4f} ms ({block_bound_ms / block_ms:.1%}); per size "
            f"{ {m: round(t, 4) for m, t in sorted(block_by_size.items())} }")
        row = {
            "name": name, "route": "cuda", "source": SHA_SOURCE,
            "replaces": spec["replaces"],
            "launches": launches,
            "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "rows": n, "state_ms": state_ms, "state_bound_ms": state_bound_ms,
            "state_plain_ms": state_plain_ms,
            "state_sizes": {str(m): c for m, c in sorted(sizes.items())},
            "launches_per_root": launches / roots,
            "host_blocks_per_s": host_rate,
            "block_launches": block_out["launches"][name], "block_ms": block_ms,
            "block_bound_ms": block_bound_ms,
        }
        if name == "tree_hash_subtrees":
            row.update(subtree_sweep(state_out, lambda m: bound(name, m)))
            row["threads"] = cuda_sha.subtree_threads(n)
        out.append(row)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    from lighthouse_tpu_torch.ops import cuda_fq

    t_start = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    log(card)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"[card] {torch.cuda.get_device_name(0)}, max SM clock {clock_mhz:.0f} MHz, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()
    max_err = phase_kernels(cuda_fq)
    max_err.update(phase_hash_kernels())
    max_err.update(phase_epoch_kernels())
    verify_out = phase_verify(cuda_fq)
    phase_parity()
    kzg_in = kzg_inputs()
    lanes = blob_lanes(*kzg_in)
    kzg_out = phase_kzg(cuda_fq, *kzg_in, lanes)
    phase_kzg_parity(lanes)
    runtime_out = phase_runtime(cuda_fq, card, *kzg_in)
    phase_hash_runtime(card)
    state_out = phase_state(card)
    epoch_out = phase_epoch(card)
    block_out = phase_block(card)
    phase_faults(cuda_fq, *kzg_in)
    kernels = phase_timing(cuda_fq, verify_out, kzg_out, block_out, max_err, clock_mhz)
    for row in kernels:
        row["runtime_launches"] = runtime_out["launches"][row["name"]]
    kernels += phase_hash_timing(state_out, block_out, max_err, clock_mhz)
    epoch_rows, programs = phase_epoch_timing(epoch_out, max_err, clock_mhz)
    kernels += epoch_rows
    log(f"[timing] epoch programs {json.dumps(programs)}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
