"""Device compute path of the PyTorch port.

The device is chosen by the tensors themselves: each kernel wrapper
(``encode_batch``, ``decode_batch``) launches its CUDA kernel for CUDA
tensors and runs its plain PyTorch version for CPU tensors. There is no
fallback: a kernel that fails to build or launch raises.
"""

from .coding import (  # noqa: F401
    FrameSpec,
    assemble_archive,
    decode,
    encode,
    narrow_values,
    validate_tables,
    walk_archive,
)
from .cuda_pack import encode_batch, encode_batch_plain  # noqa: F401
from .cuda_unpack import (  # noqa: F401
    decode_batch,
    decode_batch_plain,
    decoded_dtype,
)
