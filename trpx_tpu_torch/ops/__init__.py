"""Device compute path of the PyTorch port.

The device is chosen by the tensors themselves: each kernel wrapper
(``encode_batch``, ``decode_batch`` and, for big frames,
``encode_batch_tiled``, ``decode_batch_tiled``) launches its CUDA kernel
for CUDA tensors and runs its plain PyTorch version for CPU tensors.
There is no fallback: a kernel that fails to build or launch raises.
"""

from .coding import (  # noqa: F401
    TILED_MAX_FRAMES,
    TILED_MIN_BLOCKS,
    TILED_PACK_MAX_FRAMES,
    WALK_ON_CARD_MIN_BLOCKS,
    FrameSpec,
    InFlight,
    assemble_archive,
    decode,
    decode_collect,
    decode_dispatch,
    encode,
    encode_collect,
    encode_dispatch,
    kernel_decodes,
    narrow_values,
    pack_kernel,
    unpack_kernel,
    validate_tables,
    walk_archive,
    walk_chunks,
    walks_on_card,
)
from .cuda_pack import (  # noqa: F401
    encode_batch,
    encode_batch_plain,
    encode_batch_tiled,
    encode_batch_tiled_plain,
    tile_tables_plain,
    tiled_pack_geometry,
)
from .cuda_unpack import (  # noqa: F401
    decode_batch,
    decode_batch_plain,
    decode_batch_tiled,
    decode_batch_tiled_plain,
    decoded_dtype,
    tiled_unpack_geometry,
)
