"""Reference-API adapter: a ``jpa::Terse``-shaped class over the port's
codec, the counterpart of ``trpx_tpu/terse.py``.

It is the JAX package's class, whose building, validation and accessors
are plain numpy and import no JAX, with its two device steps replaced:
encoding the pushed frames (one batch when the archive is first needed;
frames pushed after ``from_stream`` encode on their own and are
byte-concatenated onto the loaded payload) and decoding a frame.
``device`` has ``api.compress``'s meaning: None runs device dtypes on
CUDA when a card is present and the batch reaches 4 MiB, else the native
codec; False forces the host codec; True, a torch device or its name
forces the port's ``ops.encode`` there. 64-bit frames take the host codec.
"""

from __future__ import annotations

import numpy as np

from trpx_tpu.format.pycodec import TrpxArchive, concat_archives
from trpx_tpu.terse import Terse as _ReferenceTerse


class Terse(_ReferenceTerse):
    """Accumulate frames, then serialize/decode — ``jpa::Terse`` shaped.

    >>> t = Terse(np.arange(-500, 500, dtype=np.int32), device="cuda")
    >>> t.number_of_frames, t.size
    (1, 1000)
    >>> out = t.prolix()                  # decode frame 0
    >>> with open("x.trpx", "wb") as f: t.write(f)
    """

    def __init__(self, data=None, block: int = 12, device=None):
        self._device = device
        super().__init__(data, block)

    @classmethod
    def from_stream(cls, f, device=None) -> "Terse":
        """Read a serialized ``.trpx`` stream: path, bytes, or file
        object."""
        t = super().from_stream(f)
        t._device = device
        return t

    def _encoded(self) -> TrpxArchive:
        if self._frames:
            from . import api, ops

            stack = np.stack(self._frames)  # (F, n) flat batch
            dev = None
            if stack.dtype in api._DEVICE_KINDS:
                dev = api._torch_device(
                    self._device, stack.nbytes >= api._DEVICE_MIN_BYTES)
            if dev is None:
                new = api._host_encode(stack, self._block, self._dim)
            else:
                new = ops.encode(stack, block=self._block,
                                 dimensions=self._dim, device=dev)
            # frame streams are independent and byte-aligned: the byte
            # concatenation equals a whole-stack encode
            self._archive = (new if self._archive is None
                             else concat_archives(self._archive, new))
            self._frames = []
        if self._archive is None:
            raise ValueError("empty Terse")
        return self._archive

    def prolix(self, frame: int = 0, dtype=None) -> np.ndarray:
        """Decode one frame (every index is correct). Returns (h, w) when
        the dimensions are known, else (n,). Costs O(frame size): the
        frame's payload slice decodes as a 1-frame archive."""
        from . import api

        arch = self._encoded()
        F = arch.meta.number_of_frames
        if not (0 <= frame < F):
            raise IndexError(f"frame {frame} out of range [0, {F})")
        return api.decompress(arch, dtype=dtype, device=self._device,
                              frames=frame if F > 1 else None)
