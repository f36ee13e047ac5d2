"""Percent of the card's peak memory rate that the tiled unpack reaches:
``roofline.decode_bytes`` of the traced calls over the device time of the
kernels ``decode_batch_tiled`` launches (``csrc/unpack_tiled.cu``), found
by name; None unless every frame of the process took
``decode_batch_tiled`` (``routes``): the one-pass unpack's extraction
kernel has the same name, ``unpack_tiles``."""

from portbench import roofline, routes

KERNELS = ("tile_part_bits", "tile_starts", "unpack_tiles")


def read(run, spec):
    return routes.roofline_pct(run, "decode_batch_tiled", KERNELS,
                               roofline.decode_bytes)
