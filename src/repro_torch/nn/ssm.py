"""Mamba2 (SSD) layer arguments (the reference's ``repro.nn.ssm.SSMArgs``).

Only the dataclass is ported so far, because the zamba2 configuration
names it; the layer waits for ROADMAP item 12.
"""

from __future__ import annotations

import dataclasses

__all__ = ["SSMArgs"]


@dataclasses.dataclass(frozen=True)
class SSMArgs:
    d_model: int
    d_inner: int          # expand * d_model
    head_dim: int = 64
    d_state: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 128

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state
