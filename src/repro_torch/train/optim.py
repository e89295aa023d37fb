"""AdamW with dtype-configurable moments, global-norm clip, LR schedules.

The reference's ``repro.train.optim`` on tensors: ``params``, ``grads``
and the moments are mappings from a name to a tensor (the model's
``named_parameters()``), and the update writes each parameter and moment
in place under ``torch.no_grad()``. The arithmetic is the reference's
``upd``, in float32: the clip scale, the bias corrections, the decoupled
weight decay on every leaf, and a cast back to the parameter's dtype.
``moment_dtype="bfloat16"`` halves the optimizer's memory, the
reference's knob for the 236B/314B MoE configurations.

The scalars of a step (the learning rate and the bias corrections) are
float32 host arithmetic, with ``cosf`` and ``powf`` from the C math
library (what XLA's CPU backend calls for the reference's ``jnp.cos`` and
``**``), so they are the reference's bits and the same on every device.

A leaf larger than ``CHUNK`` elements is updated (and its square summed
for the norm) a slab of leading rows at a time, so the float32
temporaries stay bounded on a leaf of billions of elements (a stacked
expert weight); every element's arithmetic is the same either way.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["OptConfig", "init_opt", "adamw_step", "lr_at", "global_norm"]

CHUNK = 1 << 26        # elements a float32 temporary holds at most
_f32 = np.float32


@functools.cache
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name, nargs in (("cosf", 1), ("powf", 2)):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float] * nargs
    return lib


def _cosf(x) -> np.float32:
    return _f32(_libm().cosf(x))


def _powf(x, y) -> np.float32:
    return _f32(_libm().powf(x, y))


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    # schedule
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _mdt(cfg: OptConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.moment_dtype]


def init_opt(params: Mapping[str, torch.Tensor], cfg: OptConfig) -> dict:
    """Zero moments of each parameter's shape, in ``cfg.moment_dtype`` and
    on its device, and the step counter (int32, 0)."""
    dt = _mdt(cfg)
    params = dict(params)
    device = next(iter(params.values())).device if params else None
    return {
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _lr32(step: int, cfg: OptConfig) -> np.float32:
    s = _f32(step)
    warm = min(s / _f32(max(cfg.warmup_steps, 1)), _f32(1.0))
    prog = (s - _f32(cfg.warmup_steps)) / _f32(max(cfg.decay_steps - cfg.warmup_steps, 1))
    prog = min(max(prog, _f32(0.0)), _f32(1.0))
    cos = _f32(0.5) * (_f32(1.0) + _cosf(_f32(math.pi) * prog))
    scale = _f32(cfg.min_lr_ratio) + _f32(1 - cfg.min_lr_ratio) * cos
    return _f32(cfg.lr) * warm * scale


def lr_at(step, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio: a float32 scalar
    tensor on the CPU (``step`` an int or a scalar tensor)."""
    return torch.tensor(_lr32(int(step), cfg), dtype=torch.float32)


def _slabs(x: torch.Tensor):
    """``x`` whole, or as views of leading-row slabs of at most ``CHUNK``
    elements each."""
    if x.numel() <= CHUNK or x.dim() == 0:
        yield slice(None)
        return
    per = max(1, CHUNK // max(1, x[0].numel()))
    for r0 in range(0, x.shape[0], per):
        yield slice(r0, r0 + per)


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    total = None
    for sl in _slabs(x):
        part = torch.sum(torch.square(x[sl].to(torch.float32)))
        total = part if total is None else total + part
    return total


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf of a mapping (or sequence)."""
    leaves = list(tree.values()) if isinstance(tree, Mapping) else list(tree)
    sq = sum(_sq_sum(x) for x in leaves)
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def adamw_step(params: Mapping[str, torch.Tensor], grads, opt_state: dict, cfg: OptConfig,
               lr: Optional[torch.Tensor] = None):
    """One AdamW update, in place. ``grads`` maps the same names (or is a
    sequence in ``params``' order). Returns ``(params, opt_state,
    metrics)``, the first two the objects passed in, updated."""
    if not isinstance(grads, Mapping):
        grads = dict(zip(params.keys(), grads))
    with torch.no_grad():
        opt_state["step"] += 1
        step = opt_state["step"]
        gnorm = global_norm(grads)
        if cfg.clip_norm > 0:
            scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        n = int(step)
        lr = lr_at(n, cfg) if lr is None else torch.as_tensor(lr, dtype=torch.float32)
        dt = _mdt(cfg)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = float(_f32(1.0) - _powf(_f32(b1), _f32(n)))
        bc2 = float(_f32(1.0) - _powf(_f32(b2), _f32(n)))
        lr_d = lr.to(gnorm.device)
        for name, p in params.items():
            g, m, v = grads[name], opt_state["m"][name], opt_state["v"][name]
            for sl in _slabs(p):
                g32 = g[sl].to(torch.float32) * scale
                m32 = b1 * m[sl].to(torch.float32) + (1 - b1) * g32
                v32 = b2 * v[sl].to(torch.float32) + (1 - b2) * g32 * g32
                mhat = m32 / bc1
                vhat = v32 / bc2
                p32 = p[sl].to(torch.float32)
                delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
                p[sl] = (p32 - lr_d * delta).to(p.dtype)
                m[sl] = m32.to(dt)
                v[sl] = v32.to(dt)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
