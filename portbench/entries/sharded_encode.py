"""``trpx_tpu_torch.parallel.ShardedCodec.encode`` of (F, n) stacks over
every card the cell asks for: one codec, made in set-up, one call a
stack, rotating over the distinct stacks."""

from __future__ import annotations

from portbench.cells import EncodeCell


class Cell(EncodeCell):
    def __init__(self, ctx) -> None:
        super().__init__(ctx)
        from trpx_tpu_torch.ops.coding import FrameSpec
        from trpx_tpu_torch.parallel import ShardedCodec

        spec = FrameSpec.for_dtype(self.n, self.dtype, self.block)
        self.codec = ShardedCodec(spec, ctx.devices)
        self.inputs = [self.frames_of(k) for k in range(self.distinct)]

    def call(self, k: int):
        return self.codec.encode(self.inputs[k % self.distinct], self.dims)

    def release(self) -> None:
        self.codec = None
