"""Host tables (numpy) cached as tensors on the device that asks for them."""

from __future__ import annotations

import functools

import numpy as np
import torch


def device_table(build):
    """Wrap ``build(*args) -> np.ndarray`` as ``f(device, *args) -> Tensor``,
    cached per (device, args): static plans are uploaded once per device."""

    @functools.lru_cache(maxsize=None)
    def on(device: torch.device, *args):
        return torch.from_numpy(np.ascontiguousarray(build(*args))).to(device)

    return on
