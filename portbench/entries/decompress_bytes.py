"""``trpx_tpu_torch.api.decompress`` of ``.trpx`` bytes as a process that
opened a file written elsewhere holds them: no sidecar, no tables, so
every call walks the stream."""

from __future__ import annotations

from portbench.cells import DecodeCell


class Cell(DecodeCell):
    def __init__(self, ctx) -> None:
        super().__init__(ctx)
        from trpx_tpu_torch import api

        self._decompress = api.decompress
        with self.by_reference():
            self.blobs = [a.to_bytes() for a in self.archives]

    def call(self, k: int):
        return self._decompress(self.blobs[k % self.distinct],
                                device=self.ctx.device_arg)
