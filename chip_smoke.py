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
             backend (default device) at 128 sets x 32 keys (valid -> True,
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
8. timing  — each kernel and its plain version at the largest shape the
             128 x 32 run gave it, beside the least time the card could take;
             then each kernel at every launch size of that run (the
             histogram ``cuda_fq.SIZES``), summed to its time per verify,
             beside its bound per verify, and likewise per 6-blob and per
             192-lane KZG batch.  Kernel times are device times of
             launches replayed from a CUDA graph, so the host's launch
             overhead does not count.

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
    res = cuda_fq.build(force=True)
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


def timed_verify(label: str, sets, expect: bool) -> dict:
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ops import verify

    t0 = time.perf_counter()
    ok = api.verify_signature_sets(sets)
    seconds = time.perf_counter() - t0
    if ok is not expect:
        raise AssertionError(f"{label}: verdict {ok}, expected {expect}")
    stages = dict(verify.LAST_STAGES)
    log(f"[verify] {label}: verdict {ok} in {seconds:.3f} s "
        f"(build {stages.get('build', 0):.3f} s, device {stages.get('device', 0):.3f} s, "
        f"verdict {stages.get('verdict', 0):.3f} s); "
        f"{len(sets) / seconds:.1f} sets/s end to end, "
        f"{len(sets) / stages.get('device', seconds):.1f} sets/s on the device program")
    return {"seconds": seconds, "stages": stages, "sets": len(sets)}


def phase_verify(cuda_fq) -> dict:
    from lighthouse_tpu_torch.crypto.bls import api, set_backend
    from lighthouse_tpu_torch.ops import verify
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
    rechecks0 = verify.COUNTERS["w_z_rechecks"]
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
    rechecks = verify.COUNTERS["w_z_rechecks"] - rechecks0
    log(f"[verify] W_z host re-checks: {rechecks}")
    return {"launches": launches, "sizes": sizes,
            "main": main, "again": again, "gossip": gossip, "rechecks": rechecks}


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
    from lighthouse_tpu_torch.ops import kzg_device

    t0 = time.perf_counter()
    ok = fn()
    seconds = time.perf_counter() - t0
    if ok is not expect:
        raise AssertionError(f"{label}: verdict {ok}, expected {expect}")
    stages = dict(kzg_device.LAST_STAGES)
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
    log(nvidia_smi("name,power.limit"))
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
    kernels = phase_timing(cuda_fq, verify_out, kzg_out, max_err, clock_mhz)
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
