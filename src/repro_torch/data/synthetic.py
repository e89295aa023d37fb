"""Synthetic corpus: zipf-distributed tokens in lognormal-length documents.

Deterministic per (seed, shard) — the same property the paper's §6 fault
tolerance relies on: a re-executed Map task reproduces its statistics, so
a restarted data shard reproduces its batches (checkpointed cursor =
(seed, step)).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np

__all__ = ["CorpusConfig", "documents", "token_batches"]


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    vocab: int = 512
    zipf_alpha: float = 1.2
    mean_doc_len: float = 180.0
    sigma_doc_len: float = 0.8
    min_doc_len: int = 8
    bos: int = 1
    eos: int = 2


def _doc_rng(cfg: CorpusConfig, seed: int, doc_id: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, doc_id]))


def documents(cfg: CorpusConfig, seed: int, start: int, count: int
              ) -> List[np.ndarray]:
    """``count`` documents (int32 token arrays), ids [start, start+count)."""
    out = []
    for d in range(start, start + count):
        rng = _doc_rng(cfg, seed, d)
        ln = int(np.clip(rng.lognormal(np.log(cfg.mean_doc_len),
                                       cfg.sigma_doc_len),
                         cfg.min_doc_len, 16 * cfg.mean_doc_len))
        # zipf over the vocab (reject ids >= vocab), reserve 0..2
        toks = rng.zipf(cfg.zipf_alpha, size=2 * ln)
        toks = toks[toks < cfg.vocab - 3][:ln].astype(np.int32) + 3
        if toks.shape[0] < ln:
            toks = np.concatenate(
                [toks, rng.integers(3, cfg.vocab, ln - toks.shape[0],
                                    dtype=np.int32)])
        toks[0] = cfg.bos
        toks[-1] = cfg.eos
        out.append(toks)
    return out


def token_batches(cfg: CorpusConfig, seed: int, batch: int, seq_len: int,
                  packer=None, start_doc: int = 0) -> Iterator[np.ndarray]:
    """Yields (batch, seq_len) int32 arrays forever.

    ``packer(docs, batch, seq_len) -> (tokens, stats)`` defaults to
    repro_torch.data.packing.pack_documents with the OS4M scheduler.
    """
    from repro_torch.data import packing

    pk = packer or (lambda docs, b, s: packing.pack_documents(
        docs, b, s, scheduler="os4m"))
    doc_id = start_doc
    while True:
        # Draw ~1.3x the tokens needed, pack, carry the doc cursor forward.
        need = batch * seq_len
        docs: List[np.ndarray] = []
        total = 0
        while total < 1.3 * need:
            block = documents(cfg, seed, doc_id, 64)
            docs.extend(block)
            total += sum(d.shape[0] for d in block)
            doc_id += 64
        tokens, _ = pk(docs, batch, seq_len)
        yield tokens
