#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lighthouse_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on a failed check:

1. card    — the card's name and power limit, as nvidia-smi reports them;
2. build   — nvcc builds csrc/fq_mul.cu for sm_90a (time and -Xptxas -v);
3. kernels — both Fq kernels against their plain PyTorch versions on the
             card, limb for limb, on canonical, redundant, negative and edge
             inputs at n in KERNEL_NS (block edges of both kernels), with values checked
             against Python integers on a sample;
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
9. faults  — the supervisor's routes on the card at small size, each with
             its exact counter deltas and none with a host fallback (on
             the card a failure raises into the caller): a
             ``device.dispatch`` error on a 4-set batch (split retry, both
             halves on the card), a hang past a short deadline (watchdog,
             ``DispatchTimeout`` raised), errors up to the breaker
             threshold (each raised; OPEN, then ``RequeueWork`` raised
             without a launch, then HALF_OPEN probes on the card back to
             CLOSED), a ``corrupt`` verdict, and a ``kzg_batch`` dispatch
             error on 2 blobs (no split, the error raised);
10. timing — each kernel and its plain version at the largest shape the
             128 x 32 run gave it, beside the least time the card could take;
             then each kernel at every launch size of that run (the
             histogram ``cuda_fq.SIZES``), summed to its time per verify,
             beside its bound per verify, and likewise per 6-blob and per
             192-lane KZG batch.  Kernel times are device times of
             launches replayed from a CUDA graph, so the host's launch
             overhead does not count.

Every verify and KZG batch of phases 4, 6 and 8 runs through the device
supervisor (``device_supervisor.py``); the script fails if any of them
took the host route or left a breaker open.  Per-batch stages come from
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


def phase_build(cuda_fq) -> dict:
    from lighthouse_tpu_torch.ops import compile_cache

    res = compile_cache.build_kernels(force=True)
    log(f"[build] nvcc {' '.join(cuda_fq.NVCC_FLAGS)}: {res.seconds:.1f} s -> {res.path.name}")
    for line in cuda_fq.ptxas_summary(res.log):
        log(f"[build] {line}")
    return {"seconds": res.seconds}


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
    for op in ("bls_verify", "kzg_batch"):
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
    if ds.breaker_state("bls_verify") != "closed" or ds.breaker_state("kzg_batch") != "closed":
        raise AssertionError("[faults] a breaker is left open")


def phase_timing(cuda_fq, verify_out: dict, kzg_out: dict, max_err: dict,
                 clock_mhz: float) -> list:
    import torch

    from lighthouse_tpu_torch.bench_kernels import OPS, graph_ms, operands, ops_per_ms, time_library

    lib, _ = cuda_fq.library(torch.device("cuda"))
    timed = time_library(lib, verify_out["sizes"], clock_mhz)
    per_kzg = {key: time_library(lib, kzg_out[key]["sizes"], clock_mhz) for key in ("kzg6", "kzg192")}
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

    phase_build(cuda_fq)
    max_err = phase_kernels(cuda_fq)
    verify_out = phase_verify(cuda_fq)
    phase_parity()
    kzg_in = kzg_inputs()
    lanes = blob_lanes(*kzg_in)
    kzg_out = phase_kzg(cuda_fq, *kzg_in, lanes)
    phase_kzg_parity(lanes)
    runtime_out = phase_runtime(cuda_fq, card, *kzg_in)
    phase_faults(cuda_fq, *kzg_in)
    kernels = phase_timing(cuda_fq, verify_out, kzg_out, max_err, clock_mhz)
    for row in kernels:
        row["runtime_launches"] = runtime_out["launches"][row["name"]]
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
