#!/usr/bin/env python3
"""Kernels 3, 8 and 2 of the port on two source trees, in turns, on one GPU.

Compares a parent commit with the working tree on the same card in one
run. Unpack the parent first into a git-ignored directory, then:

    git archive <parent> | tar -x -C build/parent
    python3 tools/kernels_38_ab.py build/parent .

Each turn is a fresh subprocess that imports ``repro_torch`` from that
tree's ``src/`` (the workload and the timers from this tree's
``chip_smoke.py``), runs batch 0 of the main path (m = 32, K = 2^21, n =
352, 4 chunks) once with the fused kernel's inputs of every chunk kept, and
times, after a warm-up:

* kernel 2 (``fused_shuffle_reduce``) at every chunk, CUDA events around
  one call as ``chip_smoke.py`` times it: chunk 0 and the sum of the four;
* kernel 3 (``segment_reduce_sorted``) at chunk 0's rows in rank order,
  the same way;
* kernel 8 (``dispatch_ranks``) at T = 2^20 Zipf(1.3) destinations with 2%
  padding, E = 64, 160 and 1,024, as device time a call
  (``chip_smoke.device_ms``: a burst behind a spin).

Every turn checks kernel 2's sums and counts at chunk 0 and kernel 3's sums
against the plain versions, bit for bit (integer values), and prints a
digest of kernel 2's chunk-0 sums on normals, which must agree between
trees. It prints ``ptxas -v``'s registers, spills and shared memory of each
kernel of the three libraries, and a digest of each kernel's SASS
instructions (equal digests: the same machine code). Turns go A, B, B, A.
Prints the card and one JSON line a turn, ``AB {...}``. Needs a CUDA
device.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBRARIES = ("fused_shuffle_reduce", "segment_reduce", "moe_dispatch")


def ptxas_summary(report: str) -> dict:
    """Per kernel (mangled name): registers, spill bytes, shared memory."""
    out, name = {}, None
    for line in report.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?",
                          line)
        if found:
            name = found.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out[name]["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out[name]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def sass_digests(build, name: str) -> dict:
    """Per kernel of library ``name``: a digest of its SASS instructions
    (``cuobjdump -sass``, without addresses and encodings), so that two
    trees' builds of one kernel can be compared whatever its mangled name."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.build(name)[name])],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        fn, body = part.split("\n", 1)
        code = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", body)
        out[fn.strip()] = hashlib.sha256("\n".join(code).encode()).hexdigest()[:16]
    return out


def turn(tree: str) -> dict:
    """One tree's times (ms), in this process."""
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.core import clustering
    from repro_torch.core.mapreduce import MapReduceConfig, MapReduceJob
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_shuffle_reduce import ops as fused_ops
    from repro_torch.kernels.fused_shuffle_reduce.ref import fused_gather_segment_reduce_ref
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.segment_reduce import ops as seg_ops
    from repro_torch.kernels.segment_reduce.ref import segment_reduce_sorted_ref

    if not repro_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {repro_torch.__file__}, not the tree {tree}")
    dev = torch.device("cuda", 0)
    _build.build(*LIBRARIES)
    out = {"tree": tree,
           "ptxas": {name: ptxas_summary(_build.ptxas_report(name)) for name in LIBRARIES},
           "sass": {name: sass_digests(_build, name) for name in LIBRARIES}}

    # The fused kernel's inputs at every chunk of batch 0's main-path run.
    n = clustering.recommended_num_clusters(cs.M)
    batch, _, _ = cs.Workload(n, dev).batch(0)
    real = fused_ops.fused_shuffle_reduce
    chunks = []

    def keep(values, gather_idx, seg_ids, num_segments):
        chunks.append((values, gather_idx, seg_ids, num_segments))
        return real(values, gather_idx, seg_ids, num_segments)

    fused_ops.fused_shuffle_reduce = keep
    try:
        MapReduceJob(lambda b: b, MapReduceConfig(num_slots=cs.M, num_clusters=n)).run(batch)
    finally:
        fused_ops.fused_shuffle_reduce = real
    del batch
    cs.check(len(chunks) == 4, "the main path ran four chunks")

    values, gather_idx, seg_ids, num_segments = chunks[0]
    got, counts = real(values, gather_idx, seg_ids, num_segments)
    want, want_counts = fused_gather_segment_reduce_ref(values, gather_idx, seg_ids,
                                                        num_segments)
    cs.check(torch.equal(got, want) and torch.equal(counts, want_counts),
             "kernel 2 == plain at chunk 0")
    del got, counts, want, want_counts
    gen = torch.Generator(device=dev).manual_seed(1)
    normals = torch.randn(values.shape, generator=gen, device=dev)
    digest = real(normals, gather_idx, seg_ids, num_segments)[0].cpu().numpy().tobytes()
    out["fused_normals_sha256"] = hashlib.sha256(digest).hexdigest()
    del normals
    out["fused_chunk_ms"] = [
        cs.cuda_ms(lambda c=c: real(*c), reps=5, warmup=1) for c in chunks]
    out["fused_ms"] = sum(out["fused_chunk_ms"])

    m, length, v = values.shape
    rows = torch.gather(values, 1, gather_idx.long()[..., None].expand(m, length, v))
    del chunks, values
    got = seg_ops.segment_reduce_sorted(rows, seg_ids, num_segments)
    cs.check(torch.equal(got, segment_reduce_sorted_ref(rows, seg_ids, num_segments)),
             "kernel 3 == plain at chunk 0")
    del got
    out["segment_ms"] = cs.cuda_ms(
        lambda: seg_ops.segment_reduce_sorted(rows, seg_ids, num_segments), reps=5, warmup=1)
    del rows, gather_idx, seg_ids
    torch.cuda.empty_cache()

    rng = np.random.default_rng(8)
    out["dispatch_ms"] = {}
    for e in (cs.DISPATCH_E, 160, 1024):
        dest_np = ((rng.zipf(1.3, cs.DISPATCH_T) - 1) % e).astype(np.int32)
        dest_np[rng.random(cs.DISPATCH_T) < 0.02] = -1
        dest = torch.as_tensor(dest_np, device=dev)
        out["dispatch_ms"][str(e)] = cs.device_ms(lambda: md_ops.dispatch_ranks(dest, e),
                                                  launches=100)[0]
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
