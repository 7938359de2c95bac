"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; arrays
cross between JAX and torch as numpy arrays.
"""

import numpy as np
import pytest
import torch

# The tier-1 suite runs several pytest-xdist workers: keep torch's intra-op
# pool small so the workers do not fight over the cores.
torch.set_num_threads(2)


def to_torch(x) -> torch.Tensor:
    """numpy or JAX array -> CPU tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def to_np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@pytest.fixture
def cuda_device() -> torch.device:
    """The GPU for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")
