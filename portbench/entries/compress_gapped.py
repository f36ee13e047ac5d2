"""``trpx_tpu_torch.api.compress`` of one (h, w) image a call in pageable
host memory, as a detector's stream interface delivers it, with the
configuration's module gaps laid over every image (``portbench.gaps``);
rotating over the distinct images."""

from __future__ import annotations

from portbench.entries import compress
from portbench.gaps import OneImage


class Cell(OneImage, compress.Cell):
    def __init__(self, ctx) -> None:
        super().__init__(ctx)
        self.inputs = [x[0] for x in self.inputs]
