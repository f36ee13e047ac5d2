"""Percent of the card's peak memory rate that the tiled pack reaches:
``roofline.encode_bytes`` of the traced calls over the device time of the
kernels ``encode_batch_tiled`` launches (``csrc/pack_tiled.cu``), found by
name; None unless every frame of the process took ``encode_batch_tiled``
(``routes``)."""

from portbench import roofline, routes

KERNELS = ("plan_tiles", "pack_starts", "place_tiles")


def read(run, spec):
    return routes.roofline_pct(run, "encode_batch_tiled", KERNELS,
                               roofline.encode_bytes)
