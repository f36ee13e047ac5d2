"""Reference-API adapter: a ``jpa::Terse``-shaped class over the port's
codec, the counterpart of ``trpx_tpu/terse.py``.

Mirrors the reference class's surface (Terse.hpp:228: constructors from
containers / streams, ``push_back``, ``prolix``, metadata accessors
:396-444, ``write`` :454) so reference-library users can port call sites
mechanically. Encoding runs when the archive is first needed, as one batch
(the reference's per-``push_back`` re-encode is its O(N²) bug P1); frames
pushed after ``from_stream`` encode on their own and are byte-concatenated
onto the loaded payload. Decoding fixes the multi-frame offset bugs B1/B2,
so ``prolix(i)`` is correct for every frame index.

``device`` has ``api.compress``'s meaning: None (the default) and True run
on the card and raise without one; a torch device or its name runs the
port's ``ops`` there (``"cpu"``: the kernels' plain versions); False runs
the native host codec. 64-bit frames take the host codec.
"""

from __future__ import annotations

import numpy as np

from .format.pycodec import TrpxArchive, concat_archives


class Terse:
    """Accumulate frames, then serialize/decode — ``jpa::Terse`` shaped.

    >>> t = Terse(np.arange(-500, 500, dtype=np.int32), device="cuda")
    >>> t.number_of_frames, t.size
    (1, 1000)
    >>> out = t.prolix()                  # decode frame 0
    >>> with open("x.trpx", "wb") as f: t.write(f)
    """

    def __init__(self, data=None, block: int = 12, device=None):
        self._block = block
        self._device = device
        self._frames: list[np.ndarray] = []
        self._dim: tuple[int, ...] = ()
        self._archive: TrpxArchive | None = None
        if data is not None:
            self.push_back(data)

    # ------------------------------------------------------------ build ---

    @classmethod
    def from_stream(cls, f, device=None) -> "Terse":
        """Read a serialized ``.trpx`` stream — path, bytes, or file
        object (Terse.hpp:279 ctor)."""
        from .io.trpx import read_trpx

        t = cls(device=device)
        t._archive = read_trpx(f)
        t._block = t._archive.meta.block
        t._dim = tuple(t._archive.meta.dimensions)
        return t

    def push_back(self, frames) -> None:
        """Append frame(s); dims must match previous pushes
        (Terse.hpp:312-319). Appending to a ``Terse`` read from a stream
        works too: the new frames encode on their own and byte-concat onto
        the loaded payload (frame streams are independent and byte-aligned,
        so the result is bit-identical to a whole-stack encode)."""
        arr = np.asarray(frames)
        if arr.dtype.kind == "f":
            arr = arr.astype(np.int64)  # CLI float path (terse.cpp:120-123)
        if arr.dtype.kind not in "iu":
            raise TypeError(f"only integral frames, got {arr.dtype}")
        if arr.ndim == 1:
            stack, dim = arr[None, :], ()
        elif arr.ndim == 2:
            stack, dim = arr.reshape(1, -1), (arr.shape[1], arr.shape[0])
        elif arr.ndim == 3:
            stack, dim = (arr.reshape(arr.shape[0], -1),
                          (arr.shape[2], arr.shape[1]))
        else:
            raise ValueError("frames must be 1-D, 2-D or 3-D")
        if self._frames or self._archive is not None:
            if stack.shape[1] != self.size:
                raise ValueError("frame size differs from the stack's")
            if (stack.dtype.kind == "i") != self.is_signed:
                raise ValueError("signedness differs from the stack's")
            if dim and self._dim and dim != self._dim:
                # same flat size but different (w, h) would silently
                # scramble prolix()'s reshape (Terse.hpp:314-319 errors)
                raise ValueError(
                    f"dimensions {dim} differ from the stack's {self._dim}")
            if not self._dim:
                self._dim = dim
        else:
            self._dim = dim
        self._frames.extend(stack)

    # ----------------------------------------------------------- encode ---

    def _encoded(self) -> TrpxArchive:
        if self._frames:
            from . import api, ops

            stack = np.stack(self._frames)  # (F, n) flat batch
            # 64-bit frames have no kernel: the host codec on any device
            dev = (api._torch_device(self._device)
                   if stack.dtype in api._DEVICE_KINDS else None)
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

    def write(self, f) -> None:
        """Serialize header + payload (Terse.hpp:454)."""
        from .io.trpx import write_trpx

        write_trpx(self._encoded(), f)

    # ----------------------------------------------------------- decode ---

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

    # ------------------------------------------------- metadata accessors ---
    # (Terse.hpp:396-444)

    @property
    def size(self) -> int:
        """Values per frame."""
        if self._archive is not None:
            return self._archive.meta.number_of_values
        return self._frames[0].shape[0] if self._frames else 0

    @property
    def number_of_frames(self) -> int:
        n = len(self._frames)  # pushed but not yet encoded
        if self._archive is not None:
            n += self._archive.meta.number_of_frames
        return n

    def dim(self) -> tuple[int, ...]:
        return self._dim

    @property
    def is_signed(self) -> bool:
        if self._archive is not None:
            return self._archive.meta.signed
        return bool(self._frames) and self._frames[0].dtype.kind == "i"

    @property
    def bits_per_val(self) -> int:
        """Max significant bits seen (``prolix_bits``)."""
        return self._encoded().meta.prolix_bits

    @property
    def terse_size(self) -> int:
        """Compressed payload bytes (``memory_size``)."""
        return self._encoded().meta.memory_size

    @property
    def block(self) -> int:
        return self._block
