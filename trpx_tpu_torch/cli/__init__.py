"""Command-line tools of the port: ``python -m trpx_tpu_torch.cli``, plus
the reference-compatible ``terse_main``/``prolix_main``."""

from .main import main, prolix_main, terse_main

__all__ = ["main", "terse_main", "prolix_main"]
