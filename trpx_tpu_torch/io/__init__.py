"""Host I/O layer of the port: ``.trpx`` file assembly, the ``.trpx.idx``
sidecar and frame subsets (a copy of ``trpx_tpu/io/trpx.py``; the TIFF
container comes with the CLI)."""

from .trpx import (
    cached_frame_offsets,
    read_trpx,
    subset_frames,
    write_index,
    write_trpx,
)

__all__ = [
    "cached_frame_offsets",
    "read_trpx",
    "subset_frames",
    "write_index",
    "write_trpx",
]
