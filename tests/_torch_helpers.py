"""Helpers shared by the PyTorch port's tests."""

import numpy as np


def pad_batch(frames: np.ndarray, spec) -> np.ndarray:
    """Zero-pad each frame (F, n) to the block grid of ``spec`` (an
    ``ops.FrameSpec``): the (F, n_padded) input of the pack kernels, as
    ``ops.staging.upload`` stages it for an encode."""
    if frames.shape[1] == spec.n_padded:
        return np.ascontiguousarray(frames)
    out = np.zeros((frames.shape[0], spec.n_padded), dtype=frames.dtype)
    out[:, : spec.n] = frames
    return out
