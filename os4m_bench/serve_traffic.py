"""The serving cells' one traffic generator: batches of requests, each a
prompt of token ids and a number of tokens to serve.

A traffic file (``traffic/<name>.json`` with ``"kind": "serve"``) fixes
``pool`` batches of ``requests_per_batch`` requests. Prompt and answer
lengths are log-normal (``median``, ``sigma``), rounded and clipped to
``[min, max]``: a batch of ``n`` holds the distribution's ``n`` quantiles
at ``(i + 0.5) / n`` of each, paired in an order drawn from the
traffic's ``shape_seed``. Every batch of the pool, at every ``--seed``,
serves that one set of lengths, so a window does the same work a batch
whether it ends after one batch or after three. ``--seed`` draws the token ids, Zipf(``token_zipf``) over the configuration's ``vocab_size``
(id ``r`` is the token of rank ``r + 1``), so routing over the experts is
uneven and differs from seed to seed. No request stops early: each is
served to its drawn length. Draws are on the host with numpy; the same
seed gives the same batches. This module imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Prompt:
    """One request as the traffic draws it."""

    tokens: np.ndarray            # (P,) int32
    max_new: int                  # tokens to serve


def lengths(spec: dict, count: int, rng: np.random.Generator) -> np.ndarray:
    """The ``count`` quantiles at ``(i + 0.5) / count`` of the log-normal
    lengths of ``spec`` (median, sigma, min, max), in an order from ``rng``."""
    normal = statistics.NormalDist()
    z = np.array([normal.inv_cdf((i + 0.5) / count) for i in range(count)])
    quantiles = spec["median"] * np.exp(spec["sigma"] * z)
    return rng.permutation(np.clip(np.rint(quantiles), spec["min"], spec["max"]).astype(np.int64))


def zipf_cdf(vocab: int, s: float) -> np.ndarray:
    """float64 CDF of Zipf(``s``) over ranks ``1 .. vocab``."""
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -s
    return np.cumsum(p / p.sum())


def draw_pool(config: dict, traffic: dict, seed: int) -> List[List[Prompt]]:
    """The traffic's ``pool`` batches for ``config``: one set of lengths
    from ``traffic["shape_seed"]`` in every batch, token ids from ``seed``."""
    shape = np.random.default_rng(int(traffic["shape_seed"]))
    ids = np.random.default_rng(int(seed) % 2 ** 64)
    vocab = int(config["vocab_size"])
    cdf = zipf_cdf(vocab, float(traffic["token_zipf"]))
    count = int(traffic["requests_per_batch"])
    prompt_lens = lengths(traffic["prompt_len"], count, shape)
    answer_lens = lengths(traffic["output_len"], count, shape)
    pool = []
    for _ in range(int(traffic["pool"])):
        ranks = np.searchsorted(cdf, ids.random(int(prompt_lens.sum())), side="right")
        tokens = np.minimum(ranks, vocab - 1).astype(np.int32)
        cuts = np.cumsum(prompt_lens)[:-1]
        pool.append([Prompt(t, int(n)) for t, n in zip(np.split(tokens, cuts), answer_lens)])
    return pool


def warmup(pool: List[List[Prompt]], count: int, max_new: int) -> List[Prompt]:
    """The ``count`` longest prompts of the pool, each served ``max_new``
    tokens: set-up's batch, which meets the largest prefill shapes."""
    prompts = sorted((p for batch in pool for p in batch), key=lambda p: -p.tokens.shape[0])
    return [Prompt(p.tokens, max_new) for p in prompts[:count]]
