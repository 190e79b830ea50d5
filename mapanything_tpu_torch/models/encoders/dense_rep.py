"""Sinusoid positional-encoding table, the port's copy.

Counterpart of ``sinusoid_encoding_table`` in
``mapanything_tpu/models/encoders/dense_rep.py`` (:22). The dense- and
global-representation encoders of that module wait for the multimodal slice.
"""

from __future__ import annotations

import numpy as np


def sinusoid_encoding_table(n_position: int, d_hid: int, base: float) -> np.ndarray:
    """(n_position, d_hid) fp32 table: sin on even channels, cos on odd ones."""
    position = np.arange(n_position)[:, None]
    div = np.power(base, 2 * (np.arange(d_hid) // 2) / d_hid)[None, :]
    table = position / div
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table.astype(np.float32)
