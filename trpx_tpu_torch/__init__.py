"""trpx_tpu_torch — the TRPX (TERSE/PROLIX) codec on PyTorch and CUDA.

A port of ``trpx_tpu`` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA
Hopper GPU. It imports nothing of the JAX package: it keeps its own copies
of the layers it needs — ``format`` (header, bit semantics, the archive
object), ``native`` (the C++ host walker and codec, built at first use
into ``_build/native/``) and ``io`` (``.trpx`` files and sidecars) — and
replaces the device path:

* ``ops/``     — encode/decode of frame batches through hand-written CUDA
  kernels (``csrc/*.cu``), each beside its plain PyTorch version, which
  CPU tensors run;
* ``api``      — ``compress`` / ``decompress``, on the card unless the
  caller asks for the CPU (``device="cpu"`` or ``device=False``);
* ``runtime/`` — ``StreamingEncoder`` (chunked encode with resume) and
  ``iter_decode`` (pipelined chunked decode) on a side CUDA stream with
  pinned staging, ``RunReport``/``StageTimer`` metrics;
* ``terse``    — ``Terse``, the ``jpa::Terse``-shaped adapter;
* ``_build``   — builds the kernels with ``nvcc`` at first use.

Importing the package loads no CUDA code and never imports ``jax``.
"""

__version__ = "0.1.0"

from .api import compress, decompress, output_dtype  # noqa: F401
from .terse import Terse  # noqa: F401

__all__ = ["Terse", "compress", "decompress", "output_dtype"]
