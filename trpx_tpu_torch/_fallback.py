"""One-shot warnings for the port's degradations to a slower path.

The port degrades where the JAX package does and the degradation exists
here: a sidecar whose tables fail ``ops.coding.validate_tables`` is
distrusted and the stream walked instead, and a sidecar write whose
native walk fails walks in pure Python. Silent degradation turns an
environment regression into an unexplained slowdown, so every such site
funnels through :func:`warn_once`: one RuntimeWarning per site per
process, carrying the triggering exception. The sites and their names
are the JAX package's (``trpx_tpu/_fallback.py``); a device fallback does
not exist in the port.
"""

from __future__ import annotations

import warnings

_seen: set[str] = set()


def warn_once(site: str, exc: BaseException | None = None,
              detail: str = "") -> None:
    """Emit one RuntimeWarning for ``site`` per process.

    ``site``: stable identifier (e.g. "ops.sidecar_tables").
    ``exc``: the exception that triggered the fallback, if any.
    ``detail``: what the fallback degrades to.
    """
    if site in _seen:
        return
    _seen.add(site)
    msg = f"trpx_tpu_torch fallback at {site}"
    if detail:
        msg += f" ({detail})"
    if exc is not None:
        msg += f": {type(exc).__name__}: {exc}"
    warnings.warn(msg, RuntimeWarning, stacklevel=3)
