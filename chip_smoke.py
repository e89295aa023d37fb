#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed S]

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all at once), holds each kernel against its plain
PyTorch version at the main path's shapes and times both, then drives the
OS4M main path — ``MapReduceJob(scheduler="os4m", pipeline_chunks=4)`` —
on three full-size batches and checks every output against a numpy
oracle. Any failed check raises, so the exit code is non-zero.

The configuration is the PUMA InvertedIndex deployment the reference's
simulator calibrates (``src/repro/core/simulator.py``): keys Zipf(0.97)
over 120,000 distinct keys, 48-byte pairs (a 4-byte key and V = 11
float32 values), the paper's cluster of 8 nodes x 4 Reduce slots (m = 32),
n = recommended_num_clusters(32) = 352 operation clusters (paper §5.4), and
K = 2^21 pairs per slot (67.1 M pairs, 3.2 GB of pairs on the device).
Values are integers in {0, 1, 2} and about 2% of pairs are invalid, so
every sum is exact in float32 and the oracle comparison is bitwise.

Output: one line per phase, a JSON line ``{"kernels": [...]}`` with each
kernel's launches on the main path, its error against the plain version
and its times, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. All numbers also go to
``chiprun_out/chip_smoke.json``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

M = 32                  # Reduce slots: 8 nodes x 4 slots
K = 2 ** 21             # pairs per slot
V = 11                  # float32 values per pair (44 B + 4 B key = 48 B)
NUM_KEYS = 120_000      # distinct keys
ZIPF_S = 0.97           # key skew of InvertedIndex
INVALID = 0.02          # share of invalid pairs
WIDE_BINS = 2 ** 17     # histogram width beyond one CTA's shared memory

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (data sheet, 700 W)
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores


def check(cond: bool, what: str) -> None:
    """Raise (non-zero exit) when a smoke check fails."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds, after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(nbytes: float, ops: float) -> tuple:
    """Least time on the card: max(bytes / memory rate, ops / f32 rate)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Workload:
    """The InvertedIndex key population: Zipf ranks -> int32 key hashes."""

    def __init__(self, num_clusters: int, device):
        ranks = np.arange(1, NUM_KEYS + 1, dtype=np.float64)
        p = ranks ** -ZIPF_S
        self.cdf = torch.as_tensor(np.cumsum(p / p.sum()), device=device)
        # Multiplicative hash of the key index: spreads keys over int32,
        # negatives included.
        self.hashes_np = (np.arange(NUM_KEYS, dtype=np.uint32)
                          * np.uint32(2654435761)).view(np.int32)
        self.hashes = torch.as_tensor(self.hashes_np, device=device)
        # The oracle's cluster of every key: |hash| % n with int32
        # wraparound and a floor-mod, as the engine defines it.
        self.cluster_np = np.mod(np.abs(self.hashes_np), num_clusters)
        self.num_clusters = num_clusters
        self.device = device

    def batch(self, seed: int):
        """One batch drawn with numpy from ``seed``: device tensors + oracle.

        Returns ``((keys, values, valid) on the device, key index on the
        host, (oracle values, oracle counts))``.
        """
        rng = np.random.default_rng(seed)
        u = torch.as_tensor(rng.random((M, K)), device=self.device)
        kidx = torch.searchsorted(self.cdf, u).clamp_(max=NUM_KEYS - 1)
        del u
        valid_np = rng.random((M, K)) >= INVALID
        values_np = rng.integers(0, 3, size=(M, K, V), dtype=np.int8)
        keys = self.hashes[kidx]
        kidx_np = kidx.to(torch.int32).cpu().numpy()
        del kidx
        values = torch.as_tensor(values_np, device=self.device).to(torch.float32)
        valid = torch.as_tensor(valid_np, device=self.device)
        cid = self.cluster_np[kidx_np[valid_np]]
        vals = values_np[valid_np]
        n = self.num_clusters
        oracle_counts = np.bincount(cid, minlength=n).astype(np.float64)
        oracle_values = np.stack(
            [np.bincount(cid, weights=vals[:, c], minlength=n) for c in range(V)],
            axis=1)
        return (keys, values, valid), kidx_np, (oracle_values, oracle_counts)


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def histogram_phase(hist_ops, histogram_ref, ids, w, num_bins, dev):
    """Kernel vs plain at one shape: bitwise check + times. Returns a dict."""
    got = hist_ops.histogram(ids, w, num_bins)
    want = histogram_ref(ids, w, num_bins)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"histogram kernel == plain at {num_bins} bins")
    m, k = ids.shape
    # bincount takes no negative ids: out-of-range ids go to one dump bin.
    flat = torch.where((ids >= 0) & (ids < num_bins),
                       ids.long() + torch.arange(m, device=dev)[:, None] * num_bins,
                       m * num_bins).reshape(-1)
    wf = w.reshape(-1)
    b, by = bound_ms(m * k * 8 + m * num_bins * 4, m * k)
    res = {
        "bins": num_bins,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: hist_ops.histogram(ids, w, num_bins)),
        "plain_ms": cuda_ms(lambda: histogram_ref(ids, w, num_bins)),
        "library_ms": cuda_ms(lambda: torch.bincount(flat, weights=wf,
                                                     minlength=m * num_bins + 1)),
        "bound_ms": b,
        "bound_by": by,
    }
    return res


class FusedProbe:
    """Stands in for ``fused_shuffle_reduce`` during one engine run.

    Every call launches the kernel as the engine would, then holds it
    against the plain version on the same inputs (bitwise: the values are
    integers), against an exact float64 sum on standard normals at the
    same shapes (|error| <= 1e-5 * sum of |values| of the segment), and
    times the kernel, the plain version and one ``index_add_`` call that
    computes the same function from the unsorted rows.
    """

    def __init__(self, real, ref):
        self.real = real
        self.ref = ref
        self.chunks = []

    def __call__(self, values, gather_idx, seg_ids, num_segments):
        out = self.real(values, gather_idx, seg_ids, num_segments)
        want = self.ref(values, gather_idx, seg_ids, num_segments)
        torch.cuda.synchronize()
        check(torch.equal(out, want), "fused kernel == plain on integer values")
        err = float((out - want).abs().max())

        m, n, v = values.shape
        ok = (seg_ids >= 0) & (seg_ids < num_segments)
        rows = int(ok.sum())
        # The library yardstick: with the segment of every unsorted row,
        # one index_add_ computes the same sums with no gather.
        seg_of_row = torch.full((m, n), num_segments, dtype=torch.long,
                                device=values.device)
        seg_of_row.scatter_(1, gather_idx.long(), seg_ids.long().clamp(0, num_segments))
        seg_of_row += torch.arange(m, device=values.device)[:, None] * (num_segments + 1)
        seg_flat = seg_of_row.reshape(-1)
        vals_flat = values.reshape(-1, v)

        def library():
            acc = torch.zeros(m * (num_segments + 1), v, device=values.device)
            return acc.index_add_(0, seg_flat, vals_flat)

        lib = library().view(m, num_segments + 1, v)[:, :num_segments]
        check(torch.equal(lib, want), "index_add_ yardstick == plain")
        del lib, seg_of_row

        float_err = self._float_check(values, gather_idx, seg_ids, num_segments, ok)
        nbytes, ops = rows * (4 + 4 * v) + m * num_segments * v * 4, rows * v
        b, by = bound_ms(nbytes, ops)
        self.chunks.append({
            "shape": [m, n, v], "segments": num_segments, "valid_rows": rows,
            "bytes": nbytes, "ops": ops,
            "max_abs_err": err, "float_rel_err": float_err,
            "ms": cuda_ms(lambda: self.real(values, gather_idx, seg_ids, num_segments),
                          reps=5, warmup=1),
            "plain_ms": cuda_ms(lambda: self.ref(values, gather_idx, seg_ids, num_segments),
                                reps=5, warmup=1),
            "library_ms": cuda_ms(library, reps=5, warmup=1),
            "bound_ms": b, "bound_by": by,
        })
        return out

    def _float_check(self, values, gather_idx, seg_ids, num_segments, ok):
        """Kernel on standard normals vs the exact (float64) segment sums."""
        m, n, v = values.shape
        gen = torch.Generator(device=values.device).manual_seed(len(self.chunks))
        normals = torch.randn(values.shape, generator=gen, device=values.device)
        got = self.real(normals, gather_idx, seg_ids, num_segments).double()
        slot = torch.arange(m, device=values.device)[:, None].expand(m, n)[ok]
        src = gather_idx[ok].long() + slot * n
        dst = seg_ids[ok].long() + slot * num_segments
        picked = normals.reshape(-1, v)[src].double()
        del normals
        exact = torch.zeros(m * num_segments, v, dtype=torch.float64, device=values.device)
        exact.index_add_(0, dst, picked)
        scale = torch.zeros_like(exact).index_add_(0, dst, picked.abs())
        diff = (got.reshape(-1, v) - exact).abs()
        check(bool((diff <= 1e-5 * scale).all()),
              "fused kernel on normals within 1e-5 * sum|x| of the exact sums")
        return float((diff / scale.clamp_min(1e-30)).max())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the first batch; batches use seed, seed+1, seed+2")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import clustering, scheduler as sched_lib
    from repro_torch.core.mapreduce import MapReduceConfig, MapReduceJob
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_shuffle_reduce import ops as fused_ops
    from repro_torch.kernels.fused_shuffle_reduce.ref import (
        fused_gather_segment_reduce_ref,
    )
    from repro_torch.kernels.histogram import ops as hist_ops
    from repro_torch.kernels.histogram.ref import histogram_ref

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    print(f"device: {smi} | torch {torch.__version__} | CUDA {torch.version.cuda}",
          flush=True)
    record = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    # ---- Build every kernel of the path (parallel nvcc).
    t0 = time.perf_counter()
    libs = _build.build("histogram", "fused_shuffle_reduce")
    record["build_s"] = time.perf_counter() - t0
    print(f"build: {record['build_s']:.1f} s -> {sorted(str(p) for p in libs.values())}",
          flush=True)

    n = clustering.recommended_num_clusters(M)
    work = Workload(n, dev)
    t0 = time.perf_counter()
    batch0, kidx0, oracle0 = work.batch(args.seed)
    print(f"data: batch {args.seed} in {time.perf_counter() - t0:.1f} s "
          f"(m={M}, K={K}, V={V}, n={n})", flush=True)
    for name, oracle in (("values", oracle0[0]), ("counts", oracle0[1])):
        check(float(oracle.max()) < 2 ** 24, f"oracle {name} below 2^24 (exact in f32)")
    hot = float(oracle0[1].max() / oracle0[1].sum())
    print(f"data: hottest cluster holds {hot:.4f} of the valid pairs", flush=True)

    # ---- Kernel phase 1: histogram, bitwise, at n and at 2^17 bins.
    keys0, _, valid0 = batch0
    ids = torch.as_tensor(work.cluster_np, device=dev)[
        torch.as_tensor(kidx0, device=dev).long()].to(torch.int32)
    w = valid0.to(torch.float32)
    hist_main = histogram_phase(hist_ops, histogram_ref, ids, w, n, dev)
    wide_ids = torch.remainder(keys0, WIDE_BINS).to(torch.int32)
    wide_ids[:, ::1000] = -1                          # out-of-range ids dropped
    hist_wide = histogram_phase(hist_ops, histogram_ref, wide_ids, w, WIDE_BINS, dev)
    del ids, wide_ids
    for h in (hist_main, hist_wide):
        print(f"kernel histogram ({M}, {K}) -> {h['bins']} bins: bitwise ok | "
              f"kernel {h['ms']:.4f} ms | plain {h['plain_ms']:.4f} ms | "
              f"bincount {h['library_ms']:.4f} ms | bound {h['bound_ms']:.4f} ms",
              flush=True)

    # ---- Kernel phase 2: fused reduce at the chunk shapes of a real plan
    # (a probe run of batch 0 that checks and times every launch).
    probe = FusedProbe(fused_ops.fused_shuffle_reduce, fused_gather_segment_reduce_ref)
    fused_ops.fused_shuffle_reduce = probe
    try:
        MapReduceJob(lambda b: b, MapReduceConfig(num_slots=M, num_clusters=n)).run(batch0)
    finally:
        fused_ops.fused_shuffle_reduce = probe.real
    check(len(probe.chunks) > 0, "probe run reached the fused kernel")
    for c in probe.chunks:
        print(f"kernel fused_shuffle_reduce {tuple(c['shape'])} -> {c['segments']} "
              f"segments, {c['valid_rows']} valid rows: bitwise ok, normals rel err "
              f"{c['float_rel_err']:.2e} | kernel {c['ms']:.4f} ms | plain "
              f"{c['plain_ms']:.4f} ms | index_add_ {c['library_ms']:.4f} ms | "
              f"bound {c['bound_ms']:.4f} ms", flush=True)
    record["histogram"] = [hist_main, hist_wide]
    record["fused_chunks"] = probe.chunks
    del probe
    torch.cuda.empty_cache()

    # ---- End to end: the main path on three batches.
    job = MapReduceJob(lambda b: b, MapReduceConfig(num_slots=M, num_clusters=n))
    check(job.device.type == "cuda", "the job runs on the card by default")
    hist_ops.launches = 0
    fused_ops.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs = []
    pipelined0 = None
    for b in range(3):
        seed = args.seed + b
        if b > 0:
            t0 = time.perf_counter()
            batch, _, oracle = work.batch(seed)
            gen_s = time.perf_counter() - t0
        else:
            batch, oracle, gen_s = batch0, oracle0, 0.0
        h0 = hist_ops.launches
        f0 = fused_ops.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = job.run(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
        chunks = job.last_plan.waves.num_chunks
        check(hist_ops.launches - h0 == 1, "phase A launched the histogram once")
        check(fused_ops.launches - f0 == chunks,
              "phase B launched the fused kernel once per chunk")
        check(res.overflow == 0, "no overflow")
        check(np.array_equal(res.values, oracle[0]), "values == numpy oracle")
        check(np.array_equal(res.counts, oracle[1]), "counts == numpy oracle")
        hash_ratio = sched_lib.schedule_hash(
            res.key_distribution, M, keys=np.arange(n)).balance_ratio
        run = {"seed": seed, "wall_ms": wall_ms, "gen_s": gen_s, "chunks": chunks,
               "chunk_caps": list(job.last_plan.chunk_caps),
               **job.last_phase_ms, "balance_os4m": float(res.schedule.balance_ratio),
               "balance_hash": float(hash_ratio), "shuffle_bytes": res.shuffle_bytes}
        runs.append(run)
        print(f"main path batch {seed}: oracle ok, overflow 0 | phase A "
              f"{run['phase_a']:.1f} ms | plan {run['plan']:.1f} ms | phase B "
              f"{run['phase_b']:.1f} ms | run {wall_ms:.1f} ms | balance os4m "
              f"{run['balance_os4m']:.4f} vs hash {run['balance_hash']:.4f}", flush=True)
        if b == 0:
            pipelined0 = (res.values, res.counts, batch)
        del batch, res
    launches = {"histogram": hist_ops.launches,
                "fused_shuffle_reduce": fused_ops.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"main path launches: {launches} | peak device memory {peak_gb:.1f} GB",
          flush=True)
    check(all(v > 0 for v in launches.values()), "every kernel ran on the main path")

    # ---- Sequential phase B on batch 0: bit-identical to the pipelined run.
    seq = MapReduceJob(lambda b: b, MapReduceConfig(
        num_slots=M, num_clusters=n, pipelined=False)).run(pipelined0[2])
    check(np.array_equal(seq.values, pipelined0[0])
          and np.array_equal(seq.counts, pipelined0[1]),
          "pipelined == sequential, bit for bit")
    print("sequential phase B on batch 0: bit-identical to pipelined", flush=True)
    record.update(runs=runs, launches=launches, peak_gb=peak_gb)

    # ---- Where the time goes: batch 0 once more, under the profiler.
    from torch.profiler import ProfilerActivity, profile

    prof_job = MapReduceJob(lambda b: b, MapReduceConfig(num_slots=M, num_clusters=n))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_job.run(pipelined0[2])
        prof_wall = (time.perf_counter() - t0) * 1e3
    on_device = torch.autograd.DeviceType.CUDA
    top = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages() if e.device_type == on_device),
                 key=lambda r: -r[1])
    # Busy time: the union of the device-side intervals (kernels, copies).
    device_ms, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in prof.events() if e.device_type == on_device):
        device_ms += max(0.0, hi - max(lo, end)) / 1e3
        end = max(end, hi)
    record["profile"] = {"wall_ms": prof_wall, "device_ms": device_ms,
                         "phases": prof_job.last_phase_ms, "top": top[:12]}
    if device_ms > 0:
        print(f"profile batch {args.seed}: run {prof_wall:.1f} ms, device busy "
              f"{device_ms:.1f} ms ({device_ms / prof_wall:.3f} of the run)", flush=True)
        for name, ms, count in top[:8]:
            print(f"  {ms:9.3f} ms  {count:4d}x  {name[:90]}", flush=True)
    else:
        print("profile: the profiler saw no device time; busy share not measured",
              flush=True)

    # ---- Result lines.
    chunks = record["fused_chunks"]
    fused_bound = bound_ms(sum(c["bytes"] for c in chunks), sum(c["ops"] for c in chunks))
    kernels = [
        {"name": "histogram", "route": "cuda",
         "source": "src/repro_torch/csrc/histogram.cu",
         "replaces": "src/repro/kernels/histogram/histogram.py:58",
         "launches": launches["histogram"], "max_abs_err": hist_main["max_abs_err"],
         "ms": hist_main["ms"], "plain_ms": hist_main["plain_ms"],
         "bound_ms": hist_main["bound_ms"], "bound_by": hist_main["bound_by"],
         "library_ms": hist_main["library_ms"]},
        # One main-path run launches the fused kernel once per chunk: its
        # times are the sums over those launches.
        {"name": "fused_shuffle_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_shuffle_reduce.cu",
         "replaces": "src/repro/kernels/fused_shuffle_reduce/fused_shuffle_reduce.py:75",
         "launches": launches["fused_shuffle_reduce"],
         "max_abs_err": max(c["max_abs_err"] for c in chunks),
         "ms": sum(c["ms"] for c in chunks),
         "plain_ms": sum(c["plain_ms"] for c in chunks),
         "bound_ms": fused_bound[0], "bound_by": fused_bound[1],
         "library_ms": sum(c["library_ms"] for c in chunks)},
    ]
    record["kernels"] = kernels
    record["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"total: {record['total_s']:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
