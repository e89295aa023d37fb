"""PUMA-analog Inverted Index on the OS4M MapReduce engine.

Builds a word → document-count index over the synthetic corpus, comparing
the default hash partitioner against the OS4M schedule — the engine-level
reproduction of the paper's headline benchmark (II), including the
pipelined reduce and the §4.3 network-cost model. Phase A runs the
histogram kernel and phase B the fused shuffle-reduce kernel on the card.

Run:  python -m repro_torch.examples.inverted_index [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.clustering import recommended_num_clusters
from repro_torch.core.mapreduce import MapReduceConfig, MapReduceJob
from repro_torch.data.synthetic import CorpusConfig, documents
from repro_torch.device import default_device
from repro_torch.examples import _common

SLOTS = 8
PAIRS_PER_SHARD = 4096
CHUNKS = 4


def inputs():
    """``(keys, vals, valid)`` numpy arrays of the Map phase, and the pair count.

    (doc_id, token) pairs, one per distinct word of a document, shuffled
    and cut to ``SLOTS`` shards of at most ``PAIRS_PER_SHARD`` pairs.
    """
    corpus = CorpusConfig(vocab=8192, zipf_alpha=1.15)
    docs = documents(corpus, seed=7, start=0, count=256)
    pairs = []
    for did, d in enumerate(docs):
        for tok in np.unique(d):          # II emits (word, doc) once per doc
            pairs.append((tok, did))
    rng = np.random.default_rng(0)
    rng.shuffle(pairs)
    pairs = pairs[: min(len(pairs) // SLOTS, PAIRS_PER_SHARD) * SLOTS]
    keys = np.asarray([p[0] for p in pairs], np.int32).reshape(SLOTS, -1)
    vals = np.ones((SLOTS, keys.shape[1], 1), np.float32)  # count 1 per doc
    valid = np.ones(keys.shape, bool)
    return keys, vals, valid, len(pairs)


def run_index(sched: str, batch, device, n_clusters: int):
    """One job under scheduler ``sched`` on the numpy ``batch``: its JobResult."""
    job = MapReduceJob(lambda shard: shard, MapReduceConfig(
        num_slots=SLOTS, num_clusters=n_clusters, scheduler=sched,
        pipeline_chunks=CHUNKS), device=device)
    return job.run(tuple(torch.as_tensor(a, device=device) for a in batch))


def main(argv=None) -> dict:
    args = _common.parser(__doc__).parse_args(argv)
    device = default_device(args.device, "examples.inverted_index")
    launches0 = _common.launch_counts()
    keys, vals, valid, n_pairs = inputs()
    n_clusters = recommended_num_clusters(SLOTS)  # §5.4: 6–16x slots
    print(f"inverted index: {n_pairs} (word, doc) pairs, {SLOTS} slots, "
          f"{n_clusters} operation clusters")
    report = {"pairs": n_pairs, "slots": SLOTS, "clusters": n_clusters, "runs": {}}
    for sched in ("hash", "os4m"):
        res = run_index(sched, (keys, vals, valid), device, n_clusters)
        top = np.argsort(-res.counts, kind="stable")[:5]
        loads = res.counts[top].astype(int).tolist()
        print(f"  {sched:5s}: balance={res.schedule.balance_ratio:.3f} "
              f"rel-std={res.schedule.rel_std:.3f} "
              f"net={res.network_cost.total / 1e6:.2f} MB "
              f"top-cluster loads={loads}")
        report["runs"][sched] = {
            "balance_ratio": res.schedule.balance_ratio,
            "rel_std": res.schedule.rel_std,
            "network_bytes": res.network_cost.total,
            "top_cluster_loads": loads,
            "assignment": res.schedule.assignment,
            "counts": res.counts,
            "values_sum": float(res.values.sum()),
        }
    return _common.finish(report, args.report, launches0)


if __name__ == "__main__":
    main()
