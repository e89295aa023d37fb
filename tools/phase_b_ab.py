#!/usr/bin/env python3
"""Phase B of the port's main, coded and sharded paths on two source trees,
in turns, on one GPU.

Compares a parent commit with the working tree on the same card in one
run. Unpack the parent first into a git-ignored directory, then:

    git archive <parent> | tar -x -C build/parent
    python3 tools/phase_b_ab.py build/parent .

Each turn is a fresh subprocess that imports ``repro_torch`` from that
tree's ``src/``, draws batch 0 of ``chip_smoke.py``'s InvertedIndex
workload (m = 32, K = 2^21, n = 352) and times ``last_phase_ms["phase_b"]``
after one warm-up run: the main path (stacked, 5 runs, outputs checked
against the numpy oracle; and 3 new jobs' first batches, each after
``torch.cuda.empty_cache()``), the coded path (m = 8, the first 2^20 pairs of
slots 0-7, ``shuffle_replication=2``, 5 runs) and the untimed sharded
backend (32 slot streams, 3 runs). Turns go A, B, B, A. Prints the card
and one JSON line a turn, ``AB {...}``. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def turn(tree: str) -> dict:
    """One tree's phase-B times (ms), in this process."""
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.core import clustering
    from repro_torch.core.mapreduce import MapReduceConfig, MapReduceJob

    if not repro_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {repro_torch.__file__}, not the tree {tree}")
    dev = torch.device("cuda", 0)
    n = clustering.recommended_num_clusters(cs.M)
    batch, _, oracle = cs.Workload(n, dev).batch(0)

    def phase_b(cfg, b, reps, **kw):
        job = MapReduceJob(lambda x: x, cfg, **kw)
        job.run(b)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            res = job.run(b)
            times.append(job.last_phase_ms["phase_b"])
        return res, times

    out = {"tree": tree}
    res, out["main"] = phase_b(MapReduceConfig(num_slots=cs.M, num_clusters=n), batch, 5)
    # A new job's first batch after the allocator's cache was emptied, as
    # chip_smoke.py's main path meets it.
    out["main_first"] = []
    for _ in range(3):
        torch.cuda.empty_cache()
        job = MapReduceJob(lambda x: x, MapReduceConfig(num_slots=cs.M, num_clusters=n))
        torch.cuda.synchronize()
        job.run(batch)
        out["main_first"].append(job.last_phase_ms["phase_b"])
        del job
    cs.check(np.array_equal(res.values, oracle[0]) and np.array_equal(res.counts, oracle[1]),
             "main path == numpy oracle")
    coded = tuple(t[:cs.CODED_M, :cs.CODED_K].contiguous() for t in batch)
    _, out["coded"] = phase_b(MapReduceConfig(
        num_slots=cs.CODED_M, num_clusters=clustering.recommended_num_clusters(cs.CODED_M),
        shuffle_replication=2), coded, 5)
    del coded
    torch.cuda.empty_cache()
    _, out["sharded"] = phase_b(MapReduceConfig(num_slots=cs.M, num_clusters=n), batch, 3,
                                backend="sharded")
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--turn":
        print("AB " + json.dumps(turn(os.path.abspath(argv[2]))), flush=True)
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = argv[1], argv[2]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for tree in (a, b, b, a):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
