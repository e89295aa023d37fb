"""The lower-precision controls of a cell's comparison: the program with its
own lossy wire switched on, at the cell's own size and load.

    python3 -m os4m_bench.control --workload <name> --wire fp8|int8|none --seeds <n> [<n> ...] --seconds <s>

Each configuration states an exact float32 wire (``quantize_shuffle``
null). The program has two lower-precision wires, each a control that the
benchmark's limits must reject: ``fp8`` (a ``float8_e4m3fn`` cast, 3
mantissa bits) and ``int8`` (one global scale a batch). ``none`` runs the
cell as stated, for the sound readings a limit is set above. Every seed
runs in this one process (the CUDA context is made once) and prints one
JSON line of its compared numbers. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

WIRES = ("fp8", "int8")


def control_cell(cell, wire: str):
    """``cell`` with the program's ``wire`` switched on (``"none"``: as stated)."""
    if wire == "none":
        return cell
    engine = dict(cell.config["engine"], quantize_shuffle=wire)
    return dataclasses.replace(cell, config=dict(cell.config, engine=engine))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--wire", choices=WIRES + ("none",), required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)

    from os4m_bench import harness, spec

    if not torch.cuda.is_available():
        print("os4m_bench.control: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = control_cell(spec.load_cell(args.workload), args.wire)
    for seed in args.seeds:
        out = harness.run_cell(cell, seed, args.seconds, False, device, time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed, "wire": args.wire,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "failed": out["failed"], "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
