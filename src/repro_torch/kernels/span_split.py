"""How kernel 8 (``csrc/moe_dispatch.cu``) reads a tile of 4-byte words.

A span of words is copied from device to shared memory as a scalar head up
to the first 16-byte boundary, a body of 16-byte loads and a scalar tail.
In the stage its first word lands at the word that has the same address
mod 16 bytes, so that the body's loads are aligned at both ends.
"""

from __future__ import annotations

__all__ = ["WORDS_A_LOAD", "span_split"]

WORDS_A_LOAD = 4  # 4-byte words of one 16-byte load


def span_split(first_word: int, words: int) -> tuple:
    """``(shift, head, units, tail)`` of the span of ``words`` words whose
    first word is word ``first_word`` of memory (its address over 4).

    Words ``[0, head)`` and ``[head + 4 units, words)`` are read one at a
    time, ``[head, head + 4 units)`` as ``units`` 16-byte loads; word ``i``
    lands at word ``shift + i`` of the stage. ``first_word + head`` and
    ``shift + head`` are multiples of 4 wherever ``units > 0``.
    """
    shift = first_word % WORDS_A_LOAD
    head = min(words, -first_word % WORDS_A_LOAD)
    units = (words - head) // WORDS_A_LOAD
    return shift, head, units, words - head - WORDS_A_LOAD * units

