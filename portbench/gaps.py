"""Module gaps of a multi-module detector, laid over a cell's frames.

A configuration's ``gaps`` gives the module grid: ``module_columns`` x
``module_rows`` modules of ``module_width`` x ``module_height`` pixels,
``gap_columns`` pixels between module columns and ``gap_rows`` between
module rows, and the ``fill`` the detector writes into every gap pixel
(2^bit_depth - 1 where the pixel mask is applied). :class:`OneImage`
makes a cell's frames such images, one a call.
"""

from __future__ import annotations

import numpy as np


def mask(height: int, width: int, gaps: dict) -> np.ndarray:
    """(height, width) bool, True on the pixels between modules; raises
    ValueError when the grid does not tile the image exactly."""
    pitch_x = gaps["module_width"] + gaps["gap_columns"]
    pitch_y = gaps["module_height"] + gaps["gap_rows"]
    if (gaps["module_columns"] * pitch_x - gaps["gap_columns"] != width
            or gaps["module_rows"] * pitch_y - gaps["gap_rows"] != height):
        raise ValueError(f"the module grid {gaps} does not tile a "
                         f"{height}x{width} image")
    cols = np.arange(width) % pitch_x >= gaps["module_width"]
    rows = np.arange(height) % pitch_y >= gaps["module_height"]
    return rows[:, None] | cols[None, :]


class OneImage:
    """Mixed in before a ``cells.EncodeCell`` or ``cells.DecodeCell``
    entry: one image a call, and the configuration's gaps laid over the
    pool of frames as ``BaseCell`` assigns it, so that every input,
    reference, probe and archive made from the pool afterwards holds
    them."""

    def __init__(self, ctx) -> None:
        if int(ctx.traffic["frames_per_call"]) != 1:
            raise ValueError("a gapped-image cell takes one image a call")
        super().__init__(ctx)

    @property
    def pool(self) -> np.ndarray:
        return self._pool

    @pool.setter
    def pool(self, frames: np.ndarray) -> None:
        gaps = self.ctx.config["gaps"]
        if gaps["fill"] > np.iinfo(frames.dtype).max:
            raise ValueError(f"gap fill {gaps['fill']} exceeds {frames.dtype}")
        frames[:, mask(self.h, self.w, gaps).reshape(-1)] = gaps["fill"]
        self._pool = frames
