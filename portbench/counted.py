"""Counted 8-bit frames, as an electron-counting camera saves them.

``synth.frames`` draws uint16 or uint32 frames only. :class:`EightBit`
draws a cell's pool from the same seed in uint16 and narrows it exactly
to the configuration's uint8 (:func:`narrow`, which refuses a count above
255), so every input, reference, probe and archive made from the pool
afterwards holds the 8-bit frames.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: the type ``synth.frames`` draws counted frames in
DRAWN = np.dtype(np.uint16)


def narrow(frames: np.ndarray) -> np.ndarray:
    """``frames`` as uint8, value for value; raises ValueError when a
    count does not fit."""
    top = int(frames.max()) if frames.size else 0
    if top > np.iinfo(np.uint8).max:
        raise ValueError(f"a count of {top} does not fit in uint8")
    return frames.astype(np.uint8)


class EightBit:
    """Mixed in before a ``cells.DecodeCell`` entry of a uint8
    configuration: ``BaseCell`` draws the pool in uint16, and the pool
    and the cell's dtype become uint8 as ``BaseCell`` assigns the pool."""

    def __init__(self, ctx) -> None:
        if np.dtype(ctx.config["dtype"]) != np.uint8:
            raise ValueError("a counted cell takes a uint8 configuration")
        super().__init__(dataclasses.replace(
            ctx, config=dict(ctx.config, dtype=DRAWN.name)))
        self.ctx = ctx

    @property
    def pool(self) -> np.ndarray:
        return self._pool

    @pool.setter
    def pool(self, frames: np.ndarray) -> None:
        self._pool = narrow(frames)
        self.dtype = self._pool.dtype
