"""``trpx_tpu_torch.api.decompress`` of one image's ``.trpx`` bytes a
call, no sidecar (``decompress_bytes``), with the configuration's module
gaps laid over every image (``portbench.gaps``). A one-image archive
decodes to (h, w), which the check compares with the image."""

from __future__ import annotations

from portbench.entries import decompress_bytes
from portbench.gaps import OneImage


class Cell(OneImage, decompress_bytes.Cell):
    def want(self, k: int):
        return super().want(k)[0]
