"""Synthetic corpus: zipf-distributed tokens in lognormal-length documents.

Deterministic per (seed, shard) — the same property the paper's §6 fault
tolerance relies on: a re-executed Map task reproduces its statistics, so
a restarted data shard reproduces its batches (checkpointed cursor =
(seed, step)).

Zipf draws go through :func:`zipf`, numpy 2.0's ``Generator.zipf``
sampler: numpy 2.1 changed that sampler, so the same seed gave other
tokens (and other example outputs) under a newer numpy. With :func:`zipf`
a seed gives the same draws on every numpy version.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterator, List

import numpy as np

__all__ = ["CorpusConfig", "documents", "token_batches", "zipf"]

_INT64_MAX = float(np.iinfo(np.int64).max)


def zipf(rng: np.random.Generator, a: float, size=None):
    """``rng.zipf(a, size)`` as numpy 2.0 draws it, on any numpy version.

    numpy 2.0's rejection sampler: each attempt takes two doubles, ``U = 1 -
    u1`` and ``V = u2``; ``X = floor(U ** (-1 / (a - 1)))`` is rejected
    outside ``[1, int64 max]`` and accepted when ``V X (T - 1) / (b - 1) <=
    T / b``, with ``T = (1 + 1/X) ** (a - 1)`` and ``b = 2 ** (a - 1)``.
    Attempts are drawn in blocks; ``rng`` then advances by exactly the
    doubles the accepted samples consumed. Powers go through ``math.pow``
    (the C library's, as numpy's sampler calls it), not a vectorised
    ``np.power``.
    """
    n = 1 if size is None else int(np.prod(size))
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    state = rng.bit_generator.state
    got: List[np.ndarray] = []
    have, attempts = 0, 0
    while have < n:
        block = max(64, 2 * (n - have))
        u = rng.random(2 * block)
        U, V = 1.0 - u[0::2], u[1::2]
        X = np.floor(np.fromiter(map(math.pow, U, itertools.repeat(-1.0 / am1)),
                                 np.float64, block))
        ok = (X <= _INT64_MAX) & (X >= 1.0)
        Xs = np.where(ok, X, 1.0)
        T = np.fromiter(map(math.pow, 1.0 + 1.0 / Xs, itertools.repeat(am1)),
                        np.float64, block)
        idx = np.nonzero(ok & (V * Xs * (T - 1.0) / (b - 1.0) <= T / b))[0]
        take = idx[:n - have]
        got.append(X[take].astype(np.int64))
        have += take.size
        attempts += int(take[-1]) + 1 if have == n and take.size else block
    rng.bit_generator.state = state
    rng.random(2 * attempts)          # the doubles numpy's sampler would take
    out = np.concatenate(got) if got else np.zeros(0, np.int64)
    return int(out[0]) if size is None else out.reshape(size)


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
        toks = zipf(rng, cfg.zipf_alpha, size=2 * ln)
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
