"""``trpx_tpu_torch.api.decompress(blob, dtype=np.uint8)`` of one movie's
``.trpx`` bytes a call, no sidecar (``decompress_bytes``): counted uint8
frames (``portbench.counted``), decoded into uint8 as a consumer of 8-bit
frames asks for them (with no dtype the stream would decode as uint16)."""

from __future__ import annotations

import numpy as np

from portbench.counted import EightBit
from portbench.entries import decompress_bytes

#: the control's largest count: what a 2-bit field holds (uint8 has no
#: narrower type)
CONTROL_TOP = 3


class Cell(EightBit, decompress_bytes.Cell):
    def call(self, k: int):
        return self._decompress(self.blobs[k % self.distinct],
                                dtype=np.uint8, device=self.ctx.device_arg)

    def control(self, k: int):
        """The frames saturated at :data:`CONTROL_TOP`, as 2-bit fields
        would clamp them, in uint8."""
        return np.minimum(self.want(k), CONTROL_TOP).astype(self.dtype)
