"""Detector frames from a seed, and the plan of which frames each call
gets.

The synthesis is ``trpx_tpu_torch/bench.py``'s ``synth``, copied here so
the yardstick does not move with the program: Poisson background with a
few hot pixels a frame at a fixed value (``BASELINE.md``'s measured mix),
drawn from a ``torch.Generator`` on the device in a few large calls.
"""

from __future__ import annotations

import numpy as np
import torch

#: values drawn in one call (bounds the sampler's temporaries)
SYNTH_VALUES = 1 << 26

_SIGNED_VIEW = {np.dtype(np.uint16): torch.int16,
                np.dtype(np.uint32): torch.int32}


def frames(count: int, n: int, dtype, pixels: dict, seed: int,
           device) -> np.ndarray:
    """(count, n) frames of ``dtype`` (uint16 or uint32) in host memory:
    Poisson(``pixels["poisson_mean"]``) with ``pixels["hot_pixels"]``
    pixels a frame set to ``pixels["hot_value"]`` (positions drawn with
    repeats, as the copied synthesis draws them), from a generator on
    ``device`` seeded with ``seed``."""
    dtype = np.dtype(dtype)
    if dtype not in _SIGNED_VIEW:
        raise ValueError(f"frames are uint16 or uint32, not {dtype}")
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = np.empty((count, n), dtype)
    step = max(1, SYNTH_VALUES // n)
    for lo in range(0, count, step):
        c = min(step, count - lo)
        rate = torch.full((c, n), float(pixels["poisson_mean"]), device=dev)
        x = torch.poisson(rate, generator=gen).to(torch.int32)
        del rate
        hot = torch.randint(0, n, (c, pixels["hot_pixels"]), generator=gen,
                            device=dev)
        x.scatter_(1, hot, int(pixels["hot_value"]))
        if dtype == np.uint16:
            x = torch.where(x >= 1 << 15, x - (1 << 16), x)
        out[lo:lo + c] = x.to(_SIGNED_VIEW[dtype]).cpu().numpy().view(dtype)
    return out


def plan(distinct: int, per_call: int, pool: int, seed: int) -> np.ndarray:
    """(distinct, per_call) pool frames of each distinct input. With a
    pool of at least ``distinct * per_call`` frames every frame is used
    once, in order; a smaller pool is walked in seeded permutations, so
    frames repeat only a pool's length apart."""
    need = distinct * per_call
    if pool >= need:
        return np.arange(need, dtype=np.int64).reshape(distinct, per_call)
    rng = np.random.default_rng(seed)
    laps = [rng.permutation(pool) for _ in range(-(-need // pool))]
    return np.concatenate(laps)[:need].reshape(distinct, per_call)
