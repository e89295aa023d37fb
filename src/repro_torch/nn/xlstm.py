"""xLSTM layer arguments (the reference's ``repro.nn.xlstm.XLSTMArgs``).

Only the dataclass is ported so far, because the xlstm configuration
names it; the mLSTM and sLSTM layers wait for ROADMAP item 12.
"""

from __future__ import annotations

import dataclasses

__all__ = ["XLSTMArgs"]


@dataclasses.dataclass(frozen=True)
class XLSTMArgs:
    d_model: int
    n_heads: int = 4
    expand: int = 2          # mLSTM up-projection factor
    conv_kernel: int = 4
    chunk: int = 64
    ffn_factor: float = 4 / 3  # sLSTM post-FFN

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def s_head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ffn(self) -> int:
        return int(self.ffn_factor * self.d_model / 64 + 1) * 64
