#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lighthouse_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on a failed check:

1. card    — the card's name and power limit, as nvidia-smi reports them;
2. build   — nvcc builds csrc/fq_mul.cu for sm_90a (time and -Xptxas -v);
3. kernels — both Fq kernels against their plain PyTorch versions on the
             card, limb for limb, on canonical, redundant, negative and edge
             inputs at n in {1, 127, 128, 129, 65536}, with values checked
             against Python integers on a sample;
4. verify  — ``crypto.bls.api.verify_signature_sets`` through the torch
             backend (default device) at 128 sets x 32 keys (valid -> True,
             one tampered set -> False) and 64 sets x 1 key (-> True); the
             launch counters of both kernels must rise during the 128 x 32 run;
5. parity  — a fixed-seed 4 x 4 batch on the card and on the CPU: the two
             final-exponentiation outputs must be equal limb for limb;
6. timing  — each kernel and its plain version at the largest shape the
             128 x 32 run gave it, beside the least time the card could take.

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

#: H100 SXM memory rate (bytes/s), int32 IMADs per clock per SM, and SMs.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_CLK_PER_SM = 64
SMS = 132
#: Integer operations and bytes one product needs, per kernel (see
#: csrc/fq_mul.cu): the 54 x 54 convolution's multiply-adds, and the
#: reduction's 61 non-unit table rows x 48 positions of multiply-adds plus
#: 48 adds for the unit rows (2^8k < p for k < 48).
FQ_OPS = 54 * 54 + 61 * 48 + 48
KERNELS = {
    "fq_mul": {"ops": FQ_OPS, "bytes": 3 * 25 * 4,
               "replaces": "lighthouse_tpu/ops/pallas_fq.py:122"},
    "fq2_mul": {"ops": 3 * FQ_OPS, "bytes": 3 * 2 * 25 * 4,
                "replaces": "lighthouse_tpu/ops/pallas_fq.py:131"},
}
SOURCE = "lighthouse_tpu_torch/csrc/fq_mul.cu"
#: Kernel check sizes; the main path's (sets, keys); the gossip batch.
KERNEL_NS = (1, 127, 128, 129, 65536)
MAIN = (128, 32)
GOSSIP = (64, 1)


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi(fields: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    after one warm-up run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    rows = dict(cuda_fq.ROWS)
    max_rows = dict(cuda_fq.MAX_ROWS)
    log(f"[verify] {tag(MAIN)} kernel launches {launches}, rows {rows}, largest launch {max_rows}")
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
    return {"launches": launches, "rows": rows, "max_rows": max_rows,
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


def phase_timing(cuda_fq, verify_out: dict, max_err: dict, clock_mhz: float) -> list:
    import torch

    ops_per_s = IMAD_PER_CLK_PER_SM * SMS * clock_mhz * 1e6
    out = []
    for name, spec in KERNELS.items():
        n = verify_out["max_rows"][name]
        tail = (25,) if name == "fq_mul" else (2, 25)
        a = torch.randint(-(1 << 20), 1 << 20, (n,) + tail, dtype=torch.int32, device="cuda")
        b = torch.randint(-(1 << 20), 1 << 20, (n,) + tail, dtype=torch.int32, device="cuda")
        kern = getattr(cuda_fq, name)
        plain = getattr(cuda_fq, f"{name}_plain")
        ms = cuda_ms(lambda: kern(a, b), reps=50)
        plain_ms = cuda_ms(lambda: plain(a, b), reps=5)
        ops_ms = n * spec["ops"] / ops_per_s * 1e3
        bytes_ms = n * spec["bytes"] / HBM_BYTES_PER_S * 1e3
        mean_rows = verify_out["rows"][name] / verify_out["launches"][name]
        small = max(1, round(mean_rows))
        xs = torch.randint(-(1 << 20), 1 << 20, (small,) + tail, dtype=torch.int32, device="cuda")
        small_ms = cuda_ms(lambda: kern(xs, xs), reps=200)
        log(f"[timing] {name} at n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f}, bytes {bytes_ms:.4f}, "
            f"SM clock {clock_mhz:.0f} MHz), {max(ops_ms, bytes_ms) / ms:.1%} of bound; "
            f"at the mean launch n={small}: {small_ms:.4f} ms")
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": spec["replaces"],
            "launches": verify_out["launches"][name],
            "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        })
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
    kernels = phase_timing(cuda_fq, verify_out, max_err, clock_mhz)
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
