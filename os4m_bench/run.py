"""Run one cell of the benchmark once and print its result line.

    python3 -m os4m_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``. A cell whose
configuration has ``"kind": "serve"`` runs ``serve_harness.run_cell``
(``repro_torch.serve.engine.Engine``), any other ``harness.run_cell``
(``MapReduceJob``). The kernels
build into ``build/repro_torch/`` of the checkout at their first use and
load from there afterwards. With ``--trace 0`` the line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the
device's busy and window seconds and a breakdown. The numbers compared
with the reference go to standard error, each beside its limit, as the
last lines, and under ``checks``, last in the result line. Without a CUDA
device, with fewer than the cell's chips, or with JAX or the JAX package
loaded once the window has closed, it prints no result and exits
non-zero.
"""

from __future__ import annotations

import time

SETUP_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from os4m_bench import harness, serve_harness, spec

    cell = spec.load_cell(args.workload)
    run_cell = serve_harness.run_cell if cell.config.get("kind") == "serve" else harness.run_cell
    if not torch.cuda.is_available():
        print("os4m_bench: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"os4m_bench: {args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} are visible; nothing was run", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, SETUP_START)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"os4m_bench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    limit = power_limit()
    out["device"]["power_limit"] = limit
    for name, metric in out["metrics"].items():
        if "roofline" in name or "mfu" in name:
            metric["power_limit"] = limit
    for name, check in out["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
