"""Run-level services of the port: streaming encode with resume,
pipelined chunked decode, metrics and profiling."""

from .metrics import RunReport, StageTimer
from .stream import StreamingEncoder, iter_decode

__all__ = ["RunReport", "StageTimer", "StreamingEncoder", "iter_decode"]
