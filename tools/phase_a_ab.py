#!/usr/bin/env python3
"""Kernels 1 and 4 and phase A of the port on two source trees, in turns,
on one GPU.

Compares a parent commit with the working tree on the same card in one
run. Unpack the parent first into a git-ignored directory, then:

    git archive <parent> | tar -x -C build/parent
    python3 tools/phase_a_ab.py build/parent .

Each turn is a fresh subprocess that imports ``repro_torch`` from that
tree's ``src/``, draws batch 0 of ``chip_smoke.py``'s InvertedIndex
workload (m = 32, K = 2^21) and times, after a warm-up:

* the histogram kernel at n = 352 and at 2^17 bins, and the sketch kernel
  at the sketch path's 2^17 cluster ids into 4 x 1024 cells, as device
  time a call (``chip_smoke.device_ms``: a burst behind a spin). Weights
  that are the validity mask: as a bool tensor where the tree's wrappers
  take one (the ``mask`` instance), and as float32 (every tree);
* phase A as ``MapReduceJob.run`` runs it (``_map_phase``, then the pull
  of the statistics to the host), host clock after a synchronise: the main
  path stacked (5 runs) and sharded (32 slot streams, 3 runs), and the
  sketch path (n = 2^17, 4 x 1024 cells) without and with
  ``stream_prefix=0.25`` (5 runs each). The main path's statistics must
  sum to the numpy oracle's counts.

It also counts, in the SASS of the tree's histogram and sketch libraries
(``cuobjdump -sass``), each kind of shared-memory atomic. Turns go A, B,
B, A. Prints the card and one JSON line a turn, ``AB {...}``. Needs a
CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sass_atomics(build, name: str) -> dict:
    """Count of each shared-memory atomic (``ATOMS.*``) and remote or
    generic atomic (``ATOM.*``, ``RED.*``) in library ``name``'s SASS."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.build(name)[name])],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    return dict(Counter(re.findall(r"\b((?:ATOMS|ATOM|RED)\.[A-Z0-9.]+)", sass)))


def turn(tree: str) -> dict:
    """One tree's times (ms), in this process."""
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.core import clustering
    from repro_torch.core.mapreduce import MapReduceConfig, MapReduceJob, _cluster_ids
    from repro_torch.core.stats_provider import CountMinParams
    from repro_torch.kernels import _build
    from repro_torch.kernels.histogram import ops as hist_ops
    from repro_torch.kernels.sketch_hist import ops as sk_ops

    if not repro_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {repro_torch.__file__}, not the tree {tree}")
    dev = torch.device("cuda", 0)
    n = clustering.recommended_num_clusters(cs.M)
    batch, _, oracle = cs.Workload(n, dev).batch(0)
    keys, _, valid = batch
    out = {"tree": tree,
           "sass": {name: sass_atomics(_build, name) for name in ("histogram", "sketch_hist")}}

    # Kernels at the path shapes.
    ids = _cluster_ids(keys, n)
    wide = torch.remainder(keys, cs.WIDE_BINS).to(torch.int32)
    sk_ids = _cluster_ids(keys, cs.SKETCH_N)
    mult = CountMinParams(cs.SKETCH_WIDTH, cs.SKETCH_DEPTH, seed=0).multipliers
    weights = {"float": valid.to(torch.float32)}
    try:
        hist_ops.histogram(ids[:1, :8], valid[:1, :8], n)
        weights["mask"] = valid
    except TypeError:
        pass                                          # a tree with one (float) instance
    kernels = {}
    for kind, w in weights.items():
        for label, fn in (
                ("histogram", lambda: hist_ops.histogram(ids, w, n)),
                ("histogram_wide", lambda: hist_ops.histogram(wide, w, cs.WIDE_BINS)),
                ("sketch_hist", lambda: sk_ops.sketch_hist(sk_ids, w, mult, cs.SKETCH_WIDTH))):
            kernels[f"{label}_{kind}"] = cs.device_ms(fn, launches=50)[0]
    out["kernels"] = kernels
    del ids, wide, sk_ids, weights
    torch.cuda.empty_cache()

    def phase_a(cfg, reps, **kw):
        job = MapReduceJob(lambda x: x, cfg, **kw)
        times = []
        for _ in range(reps + 1):                    # the first is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state = job._map_phase(batch, cfg.stream_prefix)
            hist = job._gather([st.reshape(st.shape[0], -1)
                                for st in job._as_groups(state)]).cpu().numpy()
            times.append((time.perf_counter() - t0) * 1e3)
        return hist, times[1:]

    hist, out["phase_a_main"] = phase_a(MapReduceConfig(num_slots=cs.M, num_clusters=n), 5)
    cs.check(np.array_equal(hist.sum(axis=0), oracle[1]), "main statistics == numpy oracle")
    hist, out["phase_a_sharded"] = phase_a(MapReduceConfig(num_slots=cs.M, num_clusters=n), 3,
                                           backend="sharded")
    cs.check(np.array_equal(hist.sum(axis=0), oracle[1]), "sharded statistics == numpy oracle")
    for label, prefix in (("phase_a_sketch", None), ("phase_a_sketch_prefix", 0.25)):
        _, out[label] = phase_a(MapReduceConfig(
            num_slots=cs.M, num_clusters=cs.SKETCH_N, stats="sketch",
            sketch_width=cs.SKETCH_WIDTH, sketch_depth=cs.SKETCH_DEPTH,
            stream_prefix=prefix), 5)
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
