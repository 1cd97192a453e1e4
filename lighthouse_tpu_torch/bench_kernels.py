"""Time the Fq kernels across the launches of one batch verify, beside an
earlier version of their source and beside variants of their thread layout.

    python3 -m lighthouse_tpu_torch.bench_kernels [--baseline OLD.cu]
        [--variant G=4,FQ_ROWS=32,FQ2_ROWS=8 ...] [--sets 128] [--keys 32]
        [--out bench_kernels.json]

1. Builds ``csrc/fq_mul.cu``, the ``--baseline`` source (any file with the
   same C entry points) and one copy of ``csrc/fq_mul.cu`` per
   ``--variant`` (its ``constexpr int NAME = ...;`` lines rewritten), all
   with nvcc at once, and keeps each build's registers, spills and shared
   memory (``-Xptxas -v``).
2. Runs one (sets x keys) ``verify_signature_sets`` through the torch
   backend and keeps the histogram of launch sizes of both kernels
   (``cuda_fq.SIZES``).
3. For every build, kernel and launch size of the histogram: the device time
   of one launch (:func:`graph_ms`), after checking the build's output
   against the plain version at the largest size.  The time per verify is
   the sum over the histogram of launches x time; the bound per verify the
   histogram's rows x operations at the card's peak IMAD rate.  Also the
   time at the mean launch (rows rounded), and the floor of any launch: one
   elementwise PyTorch op on one element, replayed the same way.
4. The two Fq2 routes of ``ops/tower.py`` at every Fq2 launch size of the
   histogram: ``fq2_mul`` (the Fq2 kernel) and ``fq2_many`` (the three
   Karatsuba products stacked into one Fq-kernel launch, with its stacking
   and recombination), per product row and per verify.

Prints a summary and, as its last line, one JSON object (also written to
``--out``).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

#: int32 IMADs per clock per SM and SMs of an H100 SXM; operations per Fq
#: product (see csrc/fq_mul.cu): 54 x 54 convolution multiply-adds, 61 x 48
#: reduction multiply-adds, 48 adds for the reduction's unit rows.
IMAD_PER_CLK_PER_SM = 64
SMS = 132
FQ_OPS = 54 * 54 + 61 * 48 + 48
OPS = {"fq_mul": FQ_OPS, "fq2_mul": 3 * FQ_OPS}
TAIL = {"fq_mul": (25,), "fq2_mul": (2, 25)}
ENTRY = {"fq_mul": "lt_fq_mul", "fq2_mul": "lt_fq2_mul"}


def nvidia_smi(fields: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def graph_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device milliseconds of one ``fn()``: ``reps`` calls captured in one
    CUDA graph, replayed ``rounds`` times between CUDA events, so the host's
    launch overhead does not count (back-to-back launches, warm L2)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def ops_per_ms(clock_mhz: float) -> float:
    return IMAD_PER_CLK_PER_SM * SMS * clock_mhz * 1e3


def operands(name: str, n: int, seed: int):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (n,) + TAIL[name]
    a = torch.randint(-(1 << 20), 1 << 20, shape, dtype=torch.int32, generator=gen)
    b = torch.randint(-(1 << 20), 1 << 20, shape, dtype=torch.int32, generator=gen)
    return a.cuda(), b.cuda()


def variant_source(spec: str, out_dir: Path) -> Path:
    """A copy of csrc/fq_mul.cu with ``NAME=value`` pairs of ``spec`` as its
    ``constexpr int`` constants."""
    from .ops import cuda_fq

    src = cuda_fq.SOURCE.read_text()
    for item in spec.split(","):
        name, value = item.split("=")
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};", src)
        if n != 1:
            raise ValueError(f"{name} is not a constant of {cuda_fq.SOURCE.name}")
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"fq_mul-{spec.replace(',', '-').replace('=', '')}.cu"
    path.write_text(src)
    return path


def build_all(sources: dict) -> dict:
    """nvcc on every source at once; label -> (library, seconds, ptxas lines)."""
    from .ops import cuda_fq

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {label: pool.submit(cuda_fq.build, True, path) for label, path in sources.items()}
        results = {label: f.result() for label, f in futures.items()}
    out = {}
    for label, res in results.items():
        lib = cuda_fq.load_library(res.path)
        cuda_fq.init_device(lib, torch.cuda.current_device())
        out[label] = (lib, res.seconds, cuda_fq.ptxas_summary(res.log))
    return out


def verify_histogram(n_sets: int, n_keys: int) -> dict:
    """Launch sizes of both kernels in one (n_sets x n_keys) verify."""
    from .crypto.bls import api, set_backend
    from .ops import cuda_fq
    from .workload import committee_sets

    sets = committee_sets(n_sets, n_keys, seed=3)
    set_backend("torch")
    if not api.verify_signature_sets(committee_sets(2, 2, seed=5)):
        raise AssertionError("warm-up batch did not verify")
    cuda_fq.reset_launch_counts()
    if not api.verify_signature_sets(sets):
        raise AssertionError("valid batch did not verify")
    return {name: dict(sorted(sizes.items())) for name, sizes in cuda_fq.SIZES.items()}


def launcher(lib, name: str, n: int):
    """(launch, a, b, out): a closure that launches ``lib``'s kernel ``name``
    on n rows of fresh operands into ``out``."""
    from .ops import cuda_fq

    a, b = operands(name, n, seed=n)
    out = torch.empty_like(a)
    entry = getattr(lib, ENTRY[name])

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        cuda_fq.check_cuda(lib, entry(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, stream),
                           ENTRY[name])

    return launch, a, b, out


def time_library(lib, hist: dict, clock_mhz: float) -> dict:
    """Each kernel of ``lib`` at every size of ``hist`` and at the mean
    launch, after a check against the plain version at the largest size."""
    from .ops import cuda_fq

    out = {}
    for name, sizes in hist.items():
        launch, a, b, res = launcher(lib, name, max(sizes))
        launch()
        torch.cuda.synchronize()
        if not torch.equal(res, getattr(cuda_fq, f"{name}_plain")(a, b)):
            raise AssertionError(f"{name} at n={max(sizes)}: kernel != plain")
        launches = sum(sizes.values())
        rows = sum(n * c for n, c in sizes.items())
        mean = rows / launches
        mean_n = max(1, round(mean))
        per_size = {n: graph_ms(launcher(lib, name, n)[0]) for n in sorted(set(sizes) | {mean_n})}
        out[name] = {
            "verify_ms": sum(per_size[n] * c for n, c in sizes.items()),
            "verify_bound_ms": rows * OPS[name] / ops_per_ms(clock_mhz),
            "launches": launches, "rows": rows,
            "mean_rows": mean, "at_mean": [mean_n, per_size[mean_n]],
            "at_max": [max(sizes), per_size[max(sizes)]],
            "max_bound_ms": max(sizes) * OPS[name] / ops_per_ms(clock_mhz),
            "ms_by_size": {str(n): per_size[n] for n in sorted(per_size) if n in sizes},
        }
    return out


def time_fq2_routes(sizes: dict) -> dict:
    """``tower.fq2_mul`` and ``tower.fq2_many`` at every Fq2 launch size."""
    from .ops import tower

    per_size = {}
    for n in sorted(sizes):
        a, b = operands("fq2_mul", n, seed=7 * n)
        via_kernel = tower.fq2_mul(a, b)
        (via_many,), _ = tower.fq2_many([(a, b)])
        if not torch.equal(via_kernel, via_many):
            raise AssertionError(f"fq2 routes differ at n={n}")
        per_size[n] = {"fq2_mul_ms": graph_ms(lambda: tower.fq2_mul(a, b)),
                       "fq2_many_ms": graph_ms(lambda: tower.fq2_many([(a, b)]))}
    totals = {route: sum(per_size[n][f"{route}_ms"] * c for n, c in sizes.items())
              for route in ("fq2_mul", "fq2_many")}
    rows = sum(n * c for n, c in sizes.items())
    return {"verify_ms": totals,
            "us_per_row": {route: t * 1e3 / rows for route, t in totals.items()},
            "by_size": {str(n): v for n, v in per_size.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="an earlier fq_mul.cu with the same C entry points")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=value,... constants of csrc/fq_mul.cu for one more build")
    ap.add_argument("--sets", type=int, default=128)
    ap.add_argument("--keys", type=int, default=32)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels needs a CUDA card")

    from .ops import cuda_fq

    card = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(card, flush=True)
    sources = {"current": cuda_fq.SOURCE}
    if args.baseline:
        sources["baseline"] = args.baseline
    for spec in args.variant:
        sources[spec] = variant_source(spec, cuda_fq.BUILD_DIR / "variants")
    t0 = time.perf_counter()
    libs = build_all(sources)
    print(f"[build] {len(libs)} sources in {time.perf_counter() - t0:.1f} s", flush=True)
    hist = verify_histogram(args.sets, args.keys)
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    floor_ms = graph_ms(lambda: one.add_(1))
    print(f"[floor] one elementwise launch on one element: {floor_ms:.4f} ms", flush=True)
    result = {"card": card, "sm_clock_mhz": clock_mhz, "shape": f"{args.sets}x{args.keys}",
              "launch_floor_ms": floor_ms,
              "histogram": {k: {str(n): c for n, c in v.items()} for k, v in hist.items()},
              "builds": {}}
    for label, (lib, seconds, ptxas) in libs.items():
        timed = time_library(lib, hist, clock_mhz)
        result["builds"][label] = {"build_s": seconds, "ptxas": ptxas, "kernels": timed}
        for name, t in timed.items():
            print(f"[{label}] {name}: {t['verify_ms']:.4f} ms per verify over {t['launches']} "
                  f"launches (bound {t['verify_bound_ms']:.4f} ms); n={t['at_mean'][0]} "
                  f"{t['at_mean'][1]:.4f} ms; n={t['at_max'][0]} {t['at_max'][1]:.4f} ms "
                  f"(bound {t['max_bound_ms']:.4f} ms, {t['max_bound_ms'] / t['at_max'][1]:.1%})",
                  flush=True)
        for line in ptxas:
            print(f"[{label}]   {line}", flush=True)
    routes = time_fq2_routes(hist["fq2_mul"])
    result["fq2_routes"] = routes
    print(f"[fq2 routes] per verify {routes['verify_ms']}, us per row {routes['us_per_row']}",
          flush=True)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
