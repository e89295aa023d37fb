"""The benchmark's one traffic generator: MapReduce key/value batches drawn
on the device from the seed.

A configuration fixes the pairs (``configs/<name>.json``): ``num_keys``
distinct keys drawn Zipf(``zipf_s``), each key index hashed to an int32 by
the multiplicative hash below, ``values_per_pair`` float32 values drawn
uniformly from ``value_range``, and ``invalid_share`` of the pairs
invalid; ``slots`` x ``pairs_per_slot`` pairs a batch. A traffic file
(``traffic/<name>.json``) fixes how the window feeds the job: a ``pool``
of distinct batches, cycled one job at a time after ``warmup_jobs``.

Every seed does the same work in another order. Each pool batch's keys
and validity flags are drawn once, slot by slot, from ``shape_seed`` (the
traffic file's): so the per-slot key counts, and with them the plan, its
capacities and every buffer's size, are the same for every ``--seed``.
``--seed`` then draws the order of each slot's pairs and every value.
:func:`draw_fresh` draws one more batch whose keys come from ``--seed``
as well, for the comparison after the window. All draws are a few large
calls on one ``torch.Generator`` on the device each: the same seed gives
the same batches. The arithmetic (Zipf CDF, ``searchsorted``, the hash) is
that of ``chip_smoke.py:Workload``, moved onto the device. This module
imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

# Knuth's multiplicative hash of the key index: spreads the keys over
# int32, negatives included.
KEY_HASH_MULTIPLIER = 2654435761
# Keeps the fresh batch's stream apart from the pool's on the same seed.
FRESH_SEED_OFFSET = 0x9E3779B97F4A7C15


@dataclasses.dataclass
class Batch:
    """One job's input: ``keys (m, K)`` int32 hashes, ``values (m, K, V)``
    float32, ``valid (m, K)`` bool, and the count of valid pairs."""

    keys: torch.Tensor
    values: torch.Tensor
    valid: torch.Tensor
    valid_pairs: int

    def inputs(self) -> tuple:
        """What the job's (identity) map receives."""
        return self.keys, self.values, self.valid


def key_hashes(num_keys: int, device) -> torch.Tensor:
    """The int32 hash of every key index ``0 .. num_keys - 1``."""
    idx = torch.arange(num_keys, dtype=torch.int64, device=device)
    h = (idx * KEY_HASH_MULTIPLIER) & 0xFFFFFFFF
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def zipf_cdf(num_keys: int, s: float, device) -> torch.Tensor:
    """float64 CDF of Zipf(``s``) over ranks ``1 .. num_keys``."""
    p = torch.arange(1, num_keys + 1, dtype=torch.float64, device=device) ** -s
    return torch.cumsum(p / p.sum(), dim=0)


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 64)
    return gen


def draw_batch(config: dict, shape: torch.Generator, gen: torch.Generator) -> Batch:
    """One batch of ``config``: keys and validity from ``shape``, the order
    of each slot's pairs and the values from ``gen``."""
    m, k = int(config["slots"]), int(config["pairs_per_slot"])
    v, num_keys = int(config["values_per_pair"]), int(config["num_keys"])
    lo, hi = (float(x) for x in config["value_range"])
    device = gen.device
    cdf = zipf_cdf(num_keys, float(config["zipf_s"]), device)
    u = torch.rand((m, k), generator=shape, dtype=torch.float64, device=device)
    keys = key_hashes(num_keys, device)[torch.searchsorted(cdf, u).clamp_(max=num_keys - 1)]
    del u, cdf
    valid = torch.rand((m, k), generator=shape, device=device) >= config["invalid_share"]
    order = torch.argsort(torch.rand((m, k), generator=gen, device=device), dim=1)
    keys, valid = keys.gather(1, order), valid.gather(1, order)
    del order
    values = torch.rand((m, k, v), generator=gen, device=device).mul_(hi - lo).add_(lo)
    return Batch(keys, values, valid, int(valid.sum()))


def draw_pool(config: dict, traffic: dict, seed: int, device) -> List[Batch]:
    """The ``traffic["pool"]`` batches of ``config`` drawn from ``seed``,
    their keys and validity from ``traffic["shape_seed"]``."""
    shape = generator(traffic["shape_seed"], device)
    gen = generator(seed, device)
    return [draw_batch(config, shape, gen) for _ in range(int(traffic["pool"]))]


def draw_fresh(config: dict, seed: int, device) -> Batch:
    """One batch of ``config`` drawn wholly from ``seed``: its keys, so its
    per-slot key counts, are this seed's own."""
    gen = generator(seed + FRESH_SEED_OFFSET, device)
    return draw_batch(config, gen, gen)
