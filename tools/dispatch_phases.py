#!/usr/bin/env python3
"""Where kernel 8's time goes on one GPU: per-CTA phase stamps, diagnostic
variants, and the latency of the look-back's loads.

Run from the repository root:

    python3 tools/dispatch_phases.py

It compiles instrumented copies of ``src/repro_torch/csrc/moe_dispatch.cu``
into ``build/dispatch_phases/`` (text edits of the source; the kernel's
arithmetic is the source's). Thread 0 of each CTA stamps ``%globaltimer``
after the ticket, the tile load, the per-warp counts, the published
aggregates, the look-back and the ranks, into a ``__device__`` array read
back after one call. At T = 2^20 Zipf(1.3) destinations with 2% padding
(``chip_smoke.dispatch_phase``'s data) and E = 64, 160 and 1,024 it prints,
per variant, the device time a call (``chip_smoke.device_ms``) and each
phase's end as min / median / max over the CTAs, in microseconds after the
first CTA's start. Variants:

* ``kernel``: the source as it is (its ranks and counts are checked against
  the plain version);
* ``no_ballots``: each lane its own peer group (wrong ranks, no check): the
  time the destination ballots cost;
* ``bits_unrolled``: the ballot loop unrolled at E = 64's six bits (E = 64
  only): whether the ballots are latency-bound.

Then a pointer chase (one thread, and 128 CTAs of 1,024 threads) gives the
latency of a dependent 8-byte load from L2 for ``ld.relaxed.gpu`` (the
look-back's), ``ld.volatile``, a weak ``ld.global`` and ``ld.acquire.gpu``,
in SM cycles. Prints the card and one JSON line, ``PHASES {...}``. Needs a
CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "dispatch_phases")
PHASES = ("start", "loaded", "counted", "published", "looked_back", "ranked")

# Text edits that stamp the end of each phase (anchor, stamp before it).
STAMPS = (
    ("  const long long t0 = tile * kTile;\n", 0, "after"),
    ("  // Each warp's count of each destination (order-free integer atomics).\n", 1, "before"),
    ("  // Warp offsets and the tile's aggregate; publish it (tile 0: its prefix).\n", 2, "before"),
    ("  // Decoupled look-back, a window of predecessor rows at a time. Thread\n", 3, "before"),
    ("  if (tile == ntiles - 1) {\n", 4, "before"),
)
RANKED = ("    if (k < tokens) rank[t0 + k] = valid ? prefix[d] + base + __popc(before) : -1;\n"
          "    __syncwarp();\n  }\n}\n")
VARIANTS = {
    "kernel": (),
    "no_ballots": (("    peers[i] = mask;\n",
                    "    mask = (d >= 0 && d < num_dests) ? 1u << lane : 0u;\n"
                    "    peers[i] = mask;\n"),),
    "bits_unrolled": (("    for (int b = 0; b < bits; ++b) {\n",
                       "#pragma unroll\n    for (int b = 0; b < 6; ++b) {\n"),),
}

CHASE = r'''
template <int K> __device__ __forceinline__ unsigned long long ld(const unsigned long long* p) {
  unsigned long long x;
  if (K == 0) asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(x) : "l"(p) : "memory");
  if (K == 1) asm volatile("ld.volatile.global.u64 %0, [%1];" : "=l"(x) : "l"(p) : "memory");
  if (K == 2) asm volatile("ld.global.u64 %0, [%1];" : "=l"(x) : "l"(p) : "memory");
  if (K == 3) asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(x) : "l"(p) : "memory");
  return x;
}
template <int K>
__global__ void chase(const unsigned long long* buf, unsigned long long* out, int steps, int n) {
  unsigned long long i = (blockIdx.x * 977ull + threadIdx.x * 131ull) % n;
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) i = ld<K>(buf + i);
  const long long t1 = clock64();
  if (threadIdx.x == 0) out[blockIdx.x] = t1 - t0;
  if (i == ~0ull) out[gridDim.x] = i;
}
extern "C" int chase_run(int kind, const void* buf, void* out, int blocks, int threads,
                         int steps, int n) {
  auto* b = static_cast<const unsigned long long*>(buf);
  auto* o = static_cast<unsigned long long*>(out);
  if (kind == 0) chase<0><<<blocks, threads>>>(b, o, steps, n);
  if (kind == 1) chase<1><<<blocks, threads>>>(b, o, steps, n);
  if (kind == 2) chase<2><<<blocks, threads>>>(b, o, steps, n);
  if (kind == 3) chase<3><<<blocks, threads>>>(b, o, steps, n);
  return static_cast<int>(cudaGetLastError());
}
'''
LOADS = ("ld.relaxed.gpu", "ld.volatile", "ld.global (weak)", "ld.acquire.gpu")


def instrumented(src: str, edits) -> str:
    """The kernel source with phase stamps and a variant's edits."""
    src = src.replace("namespace {\n", "namespace {\n__device__ unsigned long long g_stamp[1 << 16][8];\n"
                      "__device__ __forceinline__ unsigned long long stamp_ns() {\n"
                      "  unsigned long long t;\n"
                      "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
                      "  return t;\n}\n", 1)
    for anchor, k, where in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in moe_dispatch.cu: {anchor!r}")
        stamp = f"  if (threadIdx.x == 0) g_stamp[tile_of_cta][{k}] = stamp_ns();\n"
        src = src.replace(anchor, anchor + stamp if where == "after" else stamp + anchor)
    if src.count(RANKED) != 1:
        raise RuntimeError("the rank loop's end was not found once in moe_dispatch.cu")
    src = src.replace(RANKED, RANKED[:-2] + "  __syncthreads();\n"
                      "  if (threadIdx.x == 0) g_stamp[tile_of_cta][5] = stamp_ns();\n}\n")
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant edit not found once: {old!r}")
        src = src.replace(old, new)
    return src + '''
extern "C" int phase_stamps(void* host, int tiles) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamp, sizeof(unsigned long long) * 8 * tiles));
}
'''


def build(build_mod, name: str, text: str) -> ctypes.CDLL:
    """nvcc ``text`` as ``build/dispatch_phases/<name>.so`` (the port's flags)."""
    os.makedirs(OUT, exist_ok=True)
    src, lib = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
    with open(src, "w") as f:
        f.write(text)
    subprocess.run([build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-I", str(build_mod.CSRC_DIR),
                    "-o", lib, src], check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib)


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_dispatch.moe_dispatch import TILE_TOKENS
    from repro_torch.kernels.moe_dispatch.ref import dispatch_ranks_ref

    if not torch.cuda.is_available():
        print("dispatch_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    with open(os.path.join(_build.CSRC_DIR, "moe_dispatch.cu")) as f:
        source = f.read()
    libs = {}
    for name, edits in VARIANTS.items():
        lib = build(_build, f"moe_dispatch_{name}", instrumented(source, edits))
        lib.dispatch_ranks_i32.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
        lib.phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name] = lib
    result = {"device": smi, "phases_us": {}}
    rng = np.random.default_rng(8)
    t = cs.DISPATCH_T
    tiles = -(-t // TILE_TOKENS)
    for e in (cs.DISPATCH_E, 160, 1024):
        dest_np = ((rng.zipf(1.3, t) - 1) % e).astype(np.int32)
        dest_np[rng.random(t) < 0.02] = -1
        dest = torch.as_tensor(dest_np, device=dev)
        want = dispatch_ranks_ref(dest, e)
        for name, lib in libs.items():
            if name == "bits_unrolled" and e != cs.DISPATCH_E:
                continue
            scratch = torch.zeros(1 + tiles * e, dtype=torch.int64, device=dev)
            rank = torch.empty_like(dest)
            counts = torch.empty(e, dtype=torch.int32, device=dev)
            epoch = [0]
            stream = torch.cuda.current_stream(dev).cuda_stream

            def call():
                epoch[0] += 1
                rc = lib.dispatch_ranks_i32(dest.data_ptr(), rank.data_ptr(), counts.data_ptr(),
                                            scratch.data_ptr(), t, e, epoch[0], stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            ms = cs.device_ms(call, launches=100)[0]
            call()
            torch.cuda.synchronize()
            if name == "kernel":
                cs.check(torch.equal(rank, want[0]) and torch.equal(counts, want[1]),
                         f"instrumented kernel == plain at E={e}")
            stamps = np.zeros((tiles, 8), np.uint64)
            lib.phase_stamps(stamps.ctypes.data, tiles)
            rel = (stamps[:, :6].astype(np.int64) - int(stamps[:, 0].min())) / 1e3
            phases = {p: [float(rel[:, k].min()), float(np.median(rel[:, k])),
                          float(rel[:, k].max())] for k, p in enumerate(PHASES)}
            result["phases_us"][f"E={e} {name}"] = {"device_us": ms * 1e3, **phases}
            print(f"E={e} {name}: device {ms * 1e3:.2f} us a call | " + " | ".join(
                f"{p} {v[0]:.2f}/{v[1]:.2f}/{v[2]:.2f}" for p, v in phases.items()), flush=True)
        del want

    chase = build(_build, "load_latency", CHASE)
    chase.chase_run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int]
    n = 1 << 16
    perm = torch.randperm(n, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    buf = torch.empty(n, dtype=torch.int64, device=dev)
    buf[perm] = torch.roll(perm, 1)                  # one random cycle, 512 KB: L2-resident
    out = torch.zeros(1024 + 1, dtype=torch.int64, device=dev)
    result["load_cycles"] = {}
    for kind, label in enumerate(LOADS):
        for blocks, threads, steps in ((1, 1, 2000), (128, 1024, 200)):
            for _ in range(2):                       # the first run warms up
                out.zero_()
                chase.chase_run(kind, buf.data_ptr(), out.data_ptr(), blocks, threads, steps, n)
                torch.cuda.synchronize()
            cycles = float(out[:blocks].double().median()) / steps
            result["load_cycles"][f"{label} {blocks}x{threads}"] = cycles
            print(f"{label:18s} {blocks} x {threads}: {cycles:.0f} cycles a load (median CTA)",
                  flush=True)
    print("PHASES " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
