"""``trpx_tpu_torch.api.compress`` of (F, h, w) stacks in pageable host
memory, one call a stack, rotating over the distinct stacks."""

from __future__ import annotations

from portbench.cells import EncodeCell


class Cell(EncodeCell):
    def __init__(self, ctx) -> None:
        super().__init__(ctx)
        from trpx_tpu_torch import api

        self._compress = api.compress
        self.inputs = [self.frames_of(k).reshape(self.F, self.h, self.w)
                       for k in range(self.distinct)]

    def call(self, k: int):
        return self._compress(self.inputs[k % self.distinct],
                              block=self.block, device=self.ctx.device_arg)
