"""What the examples share: ``--device`` / ``--report`` and launch counts."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import tempfile

import numpy as np

# Every kernel wrapper's launch count: (ops module, counter).
_COUNTERS = {
    "histogram": ("repro_torch.kernels.histogram.ops", "launches"),
    "sketch_hist": ("repro_torch.kernels.sketch_hist.ops", "launches"),
    "fused_shuffle_reduce": ("repro_torch.kernels.fused_shuffle_reduce.ops", "launches"),
    "segment_reduce": ("repro_torch.kernels.segment_reduce.ops", "launches"),
    "xor_words": ("repro_torch.kernels.coded_shuffle.ops", "launches"),
    "flash_attention": ("repro_torch.kernels.flash_attention.ops", "launches"),
    "dispatch_ranks": ("repro_torch.kernels.moe_dispatch.ops", "launches"),
}


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' two common options."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where it runs (default: the current CUDA device; cpu for the CPU)")
    ap.add_argument("--report", default=None,
                    help="write the printed numbers and the kernel launches as JSON here")
    return ap


def tmp_dir(name: str) -> str:
    """A directory under the process's temporary directory (``TMPDIR``)."""
    return os.path.join(tempfile.gettempdir(), name)


def launch_counts() -> dict:
    """Each kernel wrapper's launches so far in this process."""
    return {name: getattr(importlib.import_module(mod), attr)
            for name, (mod, attr) in _COUNTERS.items()}


def _plain(x):
    """``x`` with numpy scalars and arrays as JSON values."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def finish(report: dict, path, launches0: dict) -> dict:
    """Add the launches since ``launches0``; write ``report`` to ``path``."""
    now = launch_counts()
    report["launches"] = {k: now[k] - launches0[k] for k in now}
    report = _plain(report)
    if path:
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
    return report
