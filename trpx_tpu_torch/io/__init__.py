"""Host I/O layer of the port: the greyscale TIFF container
(``io/tiff.py``), ``.trpx`` file assembly, the ``.trpx.idx`` sidecar and
frame subsets (``io/trpx.py``); copies of the JAX package's ``io``."""

from .tiff import (
    TiffError,
    TiffStack,
    TiffStream,
    TiffWriter,
    read_tiff,
    write_tiff,
)
from .trpx import (
    cached_frame_offsets,
    read_trpx,
    subset_frames,
    write_index,
    write_trpx,
)

__all__ = [
    "TiffError",
    "TiffStack",
    "TiffStream",
    "TiffWriter",
    "read_tiff",
    "write_tiff",
    "cached_frame_offsets",
    "read_trpx",
    "subset_frames",
    "write_index",
    "write_trpx",
]
