"""The control of a cell's comparison, run through the harness at the
cell's own traffic.

    python3 lhbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of ``harness.run`` on the cell's traffic with the
control in the program's place: the plain reference
(``reference.verify.verify_call``) with hash-to-G2 left without its
cofactor clearing (``reference.verify.control_hash``), each call worked out
in one of the host's worker processes.  The run is judged as a benchmark
run is, and prints the harness's own result line, whose ``correct`` has to
come out false.  Needs no card: the control runs on the host's cores.
"""

from __future__ import annotations

import argparse
import multiprocessing
import random
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path


def _control_task(args):
    from lhbench.reference.verify import control_hash, verify_call

    sigs, messages, keys, rng_seed = args
    return verify_call(sigs, messages, keys, random.Random(rng_seed), hash_fn=control_hash)


class ControlSystem:
    """The system's methods around the control, one call a worker process."""

    def __init__(self, traffic, workers: int):
        self._traffic = traffic
        self._pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
        self._batches = 0

    def call(self, call):
        t = time.perf_counter()
        keys = [[self._traffic.keys[v] for v in s] for s in call.signers]
        task = (call.sigs, call.messages, keys, f"lhbench-control-{self._traffic.seed}-{call.index}")
        verdict = self._pool.submit(_control_task, task).result()
        self._batches += 1
        return verdict, (t, t)

    def counters(self):
        return {"batches": self._batches, "sets": 0}

    def flight_records(self, after_seq):
        return []

    def last_seq(self):
        return 0

    def host_spans(self):
        return []

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)


def main(argv) -> int:
    from lhbench import gossip, harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    dep = gossip.Deployment.load(cell["config"])
    mix = gossip.Mix.load(cell["traffic"])
    stats = lambda card: {"platform": "host", "kind": card, "count": 0, "memory_peak_bytes": 0}
    rc = 0
    for seed in args.seeds:
        t_process = time.perf_counter()
        traffic = gossip.make(dep, mix, seed)
        system = ControlSystem(traffic, gossip.pool_size())
        run_args = argparse.Namespace(seconds=args.seconds, trace=0, seed=seed)
        rc = harness.run(run_args, bench, cell, traffic, system, t_process,
                         "control on the host", None, device_stats=stats) or rc
    return rc


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main(sys.argv[1:]))
