"""Frame-parallel encode/decode across devices and processes (gloo)."""

from .codec import (
    ShardedCodec,
    default_devices,
    encode_sharded,
    decode_sharded,
)

__all__ = [
    "ShardedCodec",
    "default_devices",
    "encode_sharded",
    "decode_sharded",
]
