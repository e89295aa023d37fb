#!/usr/bin/env python3
"""Kernel 9 (flash attention) of the port on source trees, in turns, on one GPU.

    python3 tools/flash_ab.py [--yardsticks] [--time-only] TREE|VARIANT ...

A tree is a checkout (the working tree, a parent unpacked with ``git
archive <parent> | tar -x -C build/parent``). A name in ``VARIANTS`` is a
copy of this tree's ``src/`` under ``build/flash_variants/<name>/`` with
``csrc/flash_attention.cu`` edited as the entry says. Each turn is a
fresh subprocess that imports ``repro_torch`` from that tree's ``src/``
(the timers from this tree's ``chip_smoke.py``), builds its flash library
and:

* prints what ``ptxas -v`` said of each kernel: registers, stack, spills;
* checks the kernel against its plain version at ``CASES`` (bf16 within
  3e-2, rows that see no key exactly 0, each launch through the instance
  ``ops.design`` names);
* times the kernel at ``TIMED`` as device time a call
  (``chip_smoke.device_ms``: a burst behind a spin), with the bound of
  each shape (q, k, v and o once at the memory rate against the causal
  flops at the bf16 tensor rate);
* with ``--yardsticks``, also times ``scaled_dot_product_attention`` and
  the simt instance (called directly) on the same inputs.

``--time-only`` records each case's error but checks nothing, for variants
that time a part of the kernel and leave its output wrong (the loads
without the products, say).

Turns go over the trees forward, then backward (A, B, B, A). Prints the
card's name and power limit and one JSON line a turn, ``AB {...}``. Needs
a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (b, hq, hkv, t, s, d, causal): MLA's and zamba2's prefills and their edges
# (ragged T < S, T > S, non-causal, a GQA group of 2, one query row), then
# the serve path's D = 128 and whisper's D = 64.
CASES = {
    "d192_mla_like": (1, 4, 4, 300, 300, 192, True),
    "d192_t65_s300": (2, 4, 4, 65, 300, 192, True),
    "d192_t_gt_s": (2, 4, 4, 130, 60, 192, True),
    "d192_noncausal": (2, 4, 4, 130, 700, 192, False),
    "d192_gqa2": (2, 8, 4, 200, 200, 192, True),
    "d192_t1": (2, 4, 4, 1, 300, 192, True),
    "d80_zamba_like": (1, 4, 4, 1000, 1000, 80, True),
    "d80_t65_s300": (2, 4, 4, 65, 300, 80, True),
    "d80_t_gt_s": (2, 4, 4, 130, 60, 80, True),
    "d80_noncausal": (2, 4, 4, 130, 700, 80, False),
    "d80_gqa2": (2, 8, 4, 200, 200, 80, True),
    "d80_t1": (2, 4, 4, 1, 300, 80, True),
    "d128_t65_s300": (2, 8, 2, 65, 300, 128, True),
    "d64_t_gt_s": (2, 8, 2, 70, 30, 64, True),
}
TIMED = {
    "mla_prefill": (8, 128, 128, 512, 512, 192, True),
    "zamba_prefill": (8, 32, 32, 1000, 1000, 80, True),
    "zamba_full": (8, 32, 32, 1024, 1024, 80, True),
    "serve": (8, 32, 8, 504, 504, 128, True),
    "whisper_encoder": (8, 8, 8, 1500, 1500, 64, False),
}


# Text edits of csrc/flash_attention.cu: (old, new) pairs, each old found
# exactly once, or (old, new, count).
_QMAJOR = [("  it.bh = w / q_tiles;\n  it.q0 = (q_tiles - 1 - w % q_tiles) * kBQ;",
            "  it.bh = w % (items / q_tiles);\n"
            "  it.q0 = (q_tiles - 1 - w / (items / q_tiles)) * kBQ;"),
           ("__device__ __forceinline__ Item item_of(int w, int q_tiles,",
            "__device__ __forceinline__ Item item_of(int w, int items, int q_tiles,"),
           ("item_of<kBK>(w, q_tiles,", "item_of<kBK>(w, items, q_tiles,", 2)]
_NATURAL = [("    if (edge && 8 * (i >> 2) + c0 + (i & 1) > lim[hf]) sc[i] = -INFINITY;\n"
             "    rmax[hf] = fmaxf(rmax[hf], sc[i]);",
             "    float x = sc[i] * scale_log2;\n"
             "    if (edge && 8 * (i >> 2) + c0 + (i & 1) > lim[hf]) x = -INFINITY;\n"
             "    sc[i] = x;\n    rmax[hf] = fmaxf(rmax[hf], x);"),
            ("    const float m_new = fmaxf(m[hf], rmax[hf] * scale_log2);\n"
             "    alpha[hf] = ex2(m[hf] - m_new);",
             "    const float m_new = fmaxf(m[hf], rmax[hf]);\n"
             "    alpha[hf] = __expf(m[hf] - m_new);"),
            ("const float p = ex2(fmaf(sc[i], scale_log2, -m[hf]));",
             "const float p = __expf(sc[i] - m[hf]);"),
            ("static_cast<int>(q_tiles), t, s, causal, scale * 1.4426950408889634f);",
             "static_cast<int>(q_tiles), t, s, causal, scale);")]
_GSTORE = [("static constexpr bool kTmaStore = kD % kPanelCols == 0;",
            "static constexpr bool kTmaStore = false;")]
_TMASTORE = [("static constexpr bool kTmaStore = kD % kPanelCols == 0;",
              "static constexpr bool kTmaStore = true;")]
_NOSTORE = [("hopper::tma_store_3d(&o_map,", "if (p < 0) hopper::tma_store_3d(&o_map,")]
_NOMATH = [("      int n_own = n;\n", "      int n_own = 0;\n"),
           ("        n_own = last < 0 ? 0 : min(n, last / kBK + 1);\n", "        n_own = 0;\n")]
_NOSOFTMAX = [("int c0, float scale_log2) {\n  float rmax[2]",
               "int c0, float scale_log2) {\n  alpha[0] = alpha[1] = l[0] = l[1] = 1.f;\n"
               "  if (c0 >= 0) return;\n  float rmax[2]")]
VARIANTS = {
    "qmajor": _QMAJOR,              # items q tile major, as at D = 64 and 128 before
    "natural": _NATURAL,            # the softmax in natural units with __expf, as before
    "gstore": _GSTORE,              # O stored from registers at every D, as before
    "tmastore": _TMASTORE,          # O stored by TMA at every D, D = 80 too
    "nomath": _NOMATH,              # loads, stores and releases only
    "nostore": _NOSTORE,            # no stores of O
    "nomath_nostore": _NOMATH + _NOSTORE,   # the loads alone
    "nosoftmax": _NOSOFTMAX,        # the products and the pipeline without the softmax
}


def variant_tree(name: str) -> str:
    """A copy of this tree's src/ with VARIANTS[name] applied; its path."""
    import shutil

    tree = os.path.join(ROOT, "build", "flash_variants", name)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src"), os.path.join(tree, "src"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(tree, "src", "repro_torch", "csrc", "flash_attention.cu")
    text = open(path).read()
    for old, new, *count in VARIANTS[name]:
        if text.count(old) != (count[0] if count else 1):
            raise RuntimeError(f"variant {name}: {old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    open(path, "w").write(text)
    return tree


def turn(tree: str, yardsticks: bool, time_only: bool) -> dict:
    """One tree's checks and times (ms), in this process."""
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    if not repro_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {repro_torch.__file__}, not the tree {tree}")
    dev = torch.device("cuda", 0)
    _build.build("flash_attention")
    out = {"tree": tree, "ptxas": cs.ptxas_kernels(_build.ptxas_report("flash_attention")),
           "cases": {}, "timed": {}}
    gen = torch.Generator(device=dev).manual_seed(9)

    def qkv(b, hq, hkv, t, s, d):
        return (torch.randn(b, hq, t, d, generator=gen, device=dev).bfloat16(),
                torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16(),
                torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16())

    for name, (b, hq, hkv, t, s, d, causal) in {**CASES, **TIMED}.items():
        q, k, v = qkv(b, hq, hkv, t, s, d)
        design = fa_ops.design(torch.bfloat16, d)
        before = dict(fa_ops.launches_by_design)
        got = fa_ops.flash_attention(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        cs.check(fa_ops.launches_by_design[design] == before[design] + 1,
                 f"{name} went through the {design} instance")
        err = float((got.float() - want.float()).abs().max())
        cs.check(time_only or err <= 3e-2,
                 f"flash ({design}) == plain within 3e-2 at {name}: {err:.3g}")
        if t > s and causal and not time_only:
            cs.check(bool(torch.all(got[:, :, :t - s] == 0)),
                     f"{name}: rows that see no key give exact 0")
        out["cases"][name] = {"design": design, "max_abs_err": err}
        if name not in TIMED:
            continue
        flops = 4 * b * hq * d * cs.attention_pairs(t, s, causal)
        nbytes = (2 * b * hq * t * d + 2 * b * hkv * s * d) * 2
        bound, by = cs.bound_ms(nbytes, flops, cs.BF16_OPS_PER_S)
        ms, _ = cs.device_ms(lambda: fa_ops.flash_attention(q, k, v, causal=causal),
                             launches=50)
        rec = {"shape": [b, hq, hkv, t, s, d], "causal": causal, "design": design, "ms": ms,
               "bound_ms": bound, "bound_by": by, "share": bound / ms,
               "tflops": flops / ms / 1e9}
        if yardsticks:
            rec["sdpa_ms"] = cs.device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True), launches=50)[0]
            if design == "wgmma":
                rec["simt_ms"] = cs.device_ms(
                    lambda: flash_attention_cuda(q, k, v, torch.empty_like(q), causal,
                                                 d ** -0.5, "simt"), launches=5, reps=3)[0]
        out["timed"][name] = rec
        del q, k, v, got, want
    return out


def main(argv) -> int:
    flags = [a for a in argv[1:] if a in ("--yardsticks", "--time-only")]
    args = [a for a in argv[1:] if a not in flags]
    if len(args) == 2 and args[0] == "--turn":
        print("AB " + json.dumps(turn(os.path.abspath(args[1]), "--yardsticks" in flags,
                                      "--time-only" in flags)), flush=True)
        return 0
    trees = [variant_tree(a) if a in VARIANTS else a for a in args]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for tree in trees + trees[::-1]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", tree] + flags,
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
