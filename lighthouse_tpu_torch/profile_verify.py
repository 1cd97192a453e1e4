"""Where the time of one batch verify goes on the card.

    python3 -m lighthouse_tpu_torch.profile_verify [--sets 128] [--keys 32]

For one (sets, keys) shape: the host's build stage (weights, validation,
hash-to-curve, limb packing), the device program's wall time (synchronised,
best of ``--reps`` after a warm-up), and one run under ``torch.profiler``:
device time by kernel, launches by kernel, and the device's busy share of
the unprofiled wall time.  Prints one JSON object as its last line.  Needs a
CUDA card; it fails without one.  :func:`trace` profiles any one run the
same way (``chip_smoke.py`` traces the KZG program with it).
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(n_sets: int, n_keys: int, reps: int) -> dict:
    from .crypto.bls.backends.host import _rand_scalars
    from .ops import pairing, verify
    from .ops.devices import resolve_device
    from .workload import committee_sets

    device = resolve_device("cuda")
    sets = committee_sets(n_sets, n_keys, seed=21)
    t0 = time.perf_counter()
    host_batch = verify.build_batch(sets, _rand_scalars(n_sets, None))
    build_s = time.perf_counter() - t0

    def run():
        fe, w_z = verify._device_verify(*verify.batch_from_numpy(host_batch, device))
        torch.cuda.synchronize(device)
        return fe

    run()  # warm-up: library load, allocator, first launches
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fe = run()
        walls.append(time.perf_counter() - t0)
    if not pairing.fe_is_one(fe):
        raise AssertionError("valid batch did not verify")
    wall_s = min(walls)

    return {
        "shape": f"{n_sets}x{n_keys}",
        "card": torch.cuda.get_device_name(0),
        "build_s": build_s,
        "device_wall_s": wall_s,
        "device_wall_runs_s": walls,
        **trace(run, wall_s),
    }


def trace(run, wall_s: float) -> dict:
    """One ``run()`` under ``torch.profiler``: device time and launches by
    kernel, and the device's busy share of ``wall_s`` (the unprofiled wall
    time of the same run).  Resets the Fq kernels' launch counts."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from .ops import cuda_fq

    cuda_fq.reset_launch_counts()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        profiled_s = time.perf_counter() - t0
    launches = dict(cuda_fq.LAUNCHES)
    # Device-side events only: a CPU op's entry also carries the device time
    # of the kernels it launched, which would count them twice.
    on_device = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if getattr(e, "device_type", None) == on_device]
    kernels = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    busy_us = sum(r[2] for r in kernels)
    fq_us = {name: sum(us for key, _, us in kernels if f"{name}_kernel" in key)
             for name in ("fq_mul", "fq2_mul")}
    return {
        "profiled_wall_s": profiled_s,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share_of_wall": busy_us / 1e6 / wall_s,
        "device_kernel_launches": sum(r[1] for r in kernels),
        "fq_kernel_launches": launches,
        "fq_kernel_device_s": {k: v / 1e6 for k, v in fq_us.items()},
        "top_kernels": [{"name": k[:80], "count": c, "device_s": us / 1e6}
                        for k, c, us in kernels[:12]],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sets", type=int, default=128)
    ap.add_argument("--keys", type=int, default=32)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    out = profile(args.sets, args.keys, args.reps)
    for k in out["top_kernels"]:
        print(f"  {k['device_s'] * 1e3:10.3f} ms  {k['count']:7d}x  {k['name']}")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
