"""Where do two machines' OS4M plans part? Runs the reference's numpy
planner (``src/repro/core/scheduler.py``, ``bss.py``, ``pipeline.py``; they
import only numpy) and the port's copy (``src/repro_torch/core/``) on the same
histograms, records each step of the plan, and compares the two packages on
this machine and, with ``--against``, this machine's record with another's.

The histograms are made once (numpy, InvertedIndex-like: Zipf(0.97) over
120,000 keys folded into n = 11 m clusters, 2^21 pairs a slot and, for
loads with many ties, 2^8; float32 counts as the engine pulls them) and
saved with the record, so a second machine replays the
very same inputs::

    python3 tools/plan_ties.py --out build/plan_ties/here.json
    # on the other machine, with build/plan_ties/here.json copied there:
    python3 tools/plan_ties.py --inputs build/plan_ties/here.json \\
        --out chiprun_out/plan_ties/there.json --against build/plan_ties/here.json

The steps, in the order the planner takes them (``scheduler.schedule_bss``
with ``eta=0.002``, then ``pipeline.plan_waves`` with 4 chunks; once with
equal slots, then again with slot 0 at half speed): the key
distribution (``hist.sum(0)``), every ``bss_approx`` call of the peeling
loop (its target's bits, its loads' digest and the subset it chose),
whether LPT's schedule won the final comparison, the final assignment,
and the waves' ranks and chunks. The first step whose record
differs is printed with the histogram it came from.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import platform
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SLOTS = (32, 8)             # the main path's slots and the coded path's
SEEDS = range(6)
SIZES = (2 ** 21, 2 ** 8)   # pairs a slot: the II deployment's, and a few
                            # (small integer loads, many of them equal)
NUM_KEYS, ZIPF_S = 120_000, 0.97
CHUNKS, ETA = 4, 0.002


def make_histograms() -> list:
    """``[(m, seed, (m, n) float32)]``: each slot's cluster counts."""
    ranks = np.arange(1, NUM_KEYS + 1, dtype=np.float64)
    p = ranks ** -ZIPF_S
    p /= p.sum()
    out = []
    for k in SIZES:
        for m in SLOTS:
            n = m * 11
            for seed in SEEDS:
                rng = np.random.default_rng(seed)
                cluster_of_key = rng.permutation(NUM_KEYS) % n
                counts = rng.multinomial(k, p, size=m)
                hist = np.zeros((m, n), np.float64)
                for j in range(m):
                    hist[j] = np.bincount(cluster_of_key, weights=counts[j], minlength=n)
                out.append((m, seed, hist.astype(np.float32)))
    return out


def digest(a) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def trace(core, hist: np.ndarray, speeds=None) -> list:
    """The planner's steps on ``hist`` through one package's ``core``
    modules, under ``speeds`` (None: P||C_max): ``[(step, value)]`` in the
    order they happen."""
    sched_mod, pipe_mod = core["scheduler"], core["pipeline"]
    m = hist.shape[0]
    steps = []
    key_dist = hist.sum(axis=0)
    steps.append(("key_dist", digest(key_dist)))
    real = sched_mod._bss.bss_approx
    calls = []

    def spy(loads, target, eta=ETA):
        chosen = real(loads, target, eta=eta)
        calls.append((len(calls), float(target).hex(), digest(np.asarray(loads, np.float64)),
                      sorted(int(i) for i in chosen)))
        return chosen

    real_lpt = sched_mod.schedule_lpt
    lpt_won = []

    def lpt_spy(*args, **kwargs):
        out = real_lpt(*args, **kwargs)
        lpt_won.append(out)
        return out

    sched_mod._bss.bss_approx, sched_mod.schedule_lpt = spy, lpt_spy
    try:
        sched = sched_mod.schedule_bss(np.asarray(key_dist, np.float64), m, eta=ETA,
                                       speeds=speeds)
    finally:
        sched_mod._bss.bss_approx, sched_mod.schedule_lpt = real, real_lpt
    for i, target, loads, chosen in calls:
        steps.append((f"bss_approx[{i}]", {"target": target, "loads": loads, "chosen": chosen}))
    won = bool(lpt_won) and sched is lpt_won[-1]
    steps.append(("lpt_won", won))
    steps.append(("assignment", np.asarray(sched.assignment).tolist()))
    waves = pipe_mod.plan_waves(np.asarray(key_dist, np.float64), sched.assignment, m, CHUNKS,
                                speeds=speeds)
    steps.append(("rank_of_cluster", np.asarray(waves.rank_of_cluster).tolist()))
    steps.append(("chunk_of_cluster", np.asarray(waves.chunk_of_cluster).tolist()))
    return steps


def packages() -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro.core import pipeline as ref_pipe, scheduler as ref_sched
    from repro_torch.core import pipeline as port_pipe, scheduler as port_sched

    return {"reference": {"scheduler": ref_sched, "pipeline": ref_pipe},
            "port": {"scheduler": port_sched, "pipeline": port_pipe}}


def first_difference(a: list, b: list):
    """The first ``(step, a's value, b's value)`` that differs, or None."""
    for (name_a, va), (name_b, vb) in zip(a, b):
        if name_a != name_b or va != vb:
            return name_a if name_a == name_b else f"{name_a} / {name_b}", va, vb
    if len(a) != len(b):
        return "number of steps", len(a), len(b)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--inputs", help="a record whose histograms to replay")
    ap.add_argument("--out", required=True, help="where to write this machine's record")
    ap.add_argument("--against", help="another machine's record to compare with")
    args = ap.parse_args(argv)
    if args.inputs:
        saved = json.loads(Path(args.inputs).read_text())
        hists = [(c["m"], c["seed"], np.asarray(c["hist"], np.float32)) for c in saved["cases"]]
    else:
        hists = make_histograms()
    pk = packages()
    record = {"machine": {"python": sys.version.split()[0], "numpy": np.__version__,
                          "platform": platform.platform(), "machine": platform.machine(),
                          "simd": {k: list(v) for k, v in getattr(np.__config__, "CONFIG", {})
                                   .get("SIMD Extensions", {}).items()}},
              "cases": []}
    differ = 0
    for m, seed, hist in hists:
        # Q||C_max too: slot 0 at half speed, as the measured path slows it.
        speeds = np.ones(m)
        speeds[0] = 0.5
        steps = {name: trace(core, hist) + [("speeds", None)] + trace(core, hist, speeds)
                 for name, core in pk.items()}
        same = first_difference(steps["reference"], steps["port"])
        if same is not None:
            differ += 1
            print(f"m={m} seed={seed}: reference and port differ first at {same[0]}: "
                  f"{same[1]} vs {same[2]}")
        record["cases"].append({"m": m, "seed": seed, "hist": hist.tolist(), "steps": steps})
    print(f"{len(hists)} histograms: the reference and the port plan alike on "
          f"{len(hists) - differ}; numpy {np.__version__}")
    if args.against:
        other = json.loads(Path(args.against).read_text())
        print(f"against {args.against} (numpy {other['machine']['numpy']}, "
              f"{other['machine']['platform']}):")
        for mine, theirs in zip(record["cases"], other["cases"]):
            if not np.array_equal(np.asarray(mine["hist"]), np.asarray(theirs["hist"])):
                print(f"  m={mine['m']} seed={mine['seed']}: the inputs differ; not compared")
                continue
            for pkg in ("reference", "port"):
                diff = first_difference(mine["steps"][pkg], theirs["steps"][pkg])
                where = ("the same plan" if diff is None else
                         f"first differs at {diff[0]}: here {diff[1]} | there {diff[2]}")
                print(f"  m={mine['m']} seed={mine['seed']} {pkg}: {where}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record))
    print(f"record -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
