"""Atomic, keep-k checkpointing of the port's training state.

The reference's contract (``repro.train.checkpoint``):

* **Atomic**: the leaves are written to ``step_XXXXXXXX.tmp``, the
  manifest last, and the directory is ``os.replace``d into place, so a
  killed writer never corrupts the latest checkpoint;
* **Keep-k**: older checkpoints are removed after a successful replace;
  no ``.tmp`` is left behind.

The layout is the port's own: a state is a nested mapping of tensors
(``{"params": {name: tensor}, "opt": {"m": {...}, "v": {...}, "step":
...}}``, the names a model's ``named_parameters()``), stored as one
``leaf_<i>.npy`` file a leaf (no zip container to checksum on the way in
and out) with each leaf's path and dtype in the manifest. numpy has no
bfloat16: a bfloat16 tensor is stored as its uint16 bits and restored
bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["save", "load", "latest_step"]

_BITS = {torch.bfloat16: (torch.int16, np.uint16)}


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + "/")
        else:
            yield path, value


def _to_numpy(x) -> tuple:
    t = torch.as_tensor(x).detach().cpu().contiguous()
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype in _BITS:
        as_int, as_np = _BITS[t.dtype]
        return t.view(as_int).numpy().view(as_np), dtype
    return t.numpy(), dtype


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    want = getattr(torch, dtype)
    if want in _BITS:
        as_int, _ = _BITS[want]
        return torch.from_numpy(arr.view(np.int16)).view(want)
    return torch.from_numpy(arr).to(want)


def save(ckpt_dir, step: int, params, opt_state=None, extra: Optional[dict] = None,
         keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = ckpt_dir / (name + ".tmp")
    final = ckpt_dir / name
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    state = {"params": params}
    if opt_state is not None:
        state["opt"] = opt_state
    paths, dtypes = [], []
    for i, (path, leaf) in enumerate(_flatten(state)):
        array, dtype = _to_numpy(leaf)
        np.save(tmp / f"leaf_{i}.npy", array)
        paths.append(path)
        dtypes.append(dtype)
    manifest = {"step": step, "num_leaves": len(paths), "paths": paths, "dtypes": dtypes,
                "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)

    # keep-k GC (after the successful replace).
    steps = sorted(d for d in ckpt_dir.iterdir()
                   if d.is_dir() and d.name.startswith("step_")
                   and not d.name.endswith(".tmp"))
    for old in steps[:-keep]:
        shutil.rmtree(old)
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
                   if d.is_dir() and d.name.startswith("step_")
                   and not d.name.endswith(".tmp"))
    return steps[-1] if steps else None


def load(ckpt_dir, step: int):
    """The state saved at ``step`` as nested dicts of CPU tensors (each in
    its saved dtype, bit for bit), and the manifest's ``extra``."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    state: dict = {}
    for i, (path, dtype) in enumerate(zip(manifest["paths"], manifest["dtypes"])):
        *parents, leaf = path.split("/")
        node = state
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = _from_numpy(np.load(d / f"leaf_{i}.npy"), dtype)
    return state, manifest["extra"]
