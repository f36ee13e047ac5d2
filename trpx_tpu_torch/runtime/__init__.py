"""Run-level services of the port: streaming encode with resume,
pipelined chunked decode, metrics and profiling.

``stream`` loads on first use of its names: it imports ``ops``, whose
spans come from ``metrics``, so ``ops`` can import ``metrics`` without
this package importing ``ops`` back."""

from .metrics import RunReport, StageTimer

__all__ = ["RunReport", "StageTimer", "StreamingEncoder", "iter_decode"]


def __getattr__(name: str):
    if name in ("StreamingEncoder", "iter_decode"):
        from . import stream

        return getattr(stream, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
