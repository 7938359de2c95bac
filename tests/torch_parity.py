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


# ---- a small heterogeneous multi-UE uplink slot ---------------------------

SLOT_PRB = 24
SLOT_PORTS = 2
SLOT_SNR_DB = 25.0
# (rnti, first_rb, rb_count, MCS of the qam64 table): two 64QAM grants that
# share a config, a QPSK MCS-0 grant whose E exceeds its circular buffer
# (repetition), and a 16QAM grant.
SLOT_PLAN = [(0x4601, 0, 8, 20), (0x4602, 8, 8, 20), (0x4603, 16, 4, 0), (0x4604, 20, 4, 10)]
RETX_UE = 1
RETX_ATTENUATION_DB = 14.0


def slot_config(pusch_mod, modulation_cls, rb_count: int, mcs: int, first_rb: int, rv: int = 0,
                nof_ports: int = SLOT_PORTS):
    """The PuschConfig of one grant, in either package (with that
    package's own Allocation): the flagship's symbols 1-13 with DM-RS on
    symbol 2, one layer, a compact window at first_rb (crb_start)."""
    from srsran_project_tpu_torch.ran import tbs as tbs_mod
    from srsran_project_tpu_torch.ran.constants import NRE

    qm, rate = tbs_mod.mcs_to_qm_rate(mcs, "qam64")
    return pusch_mod.PuschConfig(
        tbs=tbs_mod.calculate_tbs(rb_count, 13, NRE, rate, qm, 1), target_code_rate=rate,
        modulation=modulation_cls(qm),
        alloc=pusch_mod.alloc_mod.Allocation(rb_start=0, rb_count=rb_count, sym_start=1,
                                             sym_count=13, dmrs_symbols=(2,),
                                             crb_start=first_rb),
        nof_layers=1, nof_rx_ports=nof_ports, nof_grid_sc=rb_count * 12, rv=rv)


def small_slot(rv_retx=None, noise_seed: int = 0, atten_db: float = RETX_ATTENUATION_DB):
    """Port PuschConfigs, TBs and the received (2, 14, 288) grid of the
    small slot.  Each UE sends a TB through a random unit-norm 2-port
    precoder (both from seed 0); UE RETX_UE is attenuated by ``atten_db``
    so that its rv 0 fails and rv 0 + rv 2 passes; with ``rv_retx`` it
    sends that rv instead.  Returns (configs, tbs, grid)."""
    from srsran_project_tpu_torch.ops.modulation import Modulation
    from srsran_project_tpu_torch.phy import pusch

    rng = np.random.default_rng(0)
    grid = torch.zeros((SLOT_PORTS, 14, SLOT_PRB * 12), dtype=torch.complex64)
    cfgs, tbs = [], []
    for ue, (rnti, rb0, nrb, mcs) in enumerate(SLOT_PLAN):
        rv = rv_retx if (ue == RETX_UE and rv_retx is not None) else 0
        cfg = slot_config(pusch, Modulation, nrb, mcs, rb0, rv)
        tb = rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8)
        w = rng.standard_normal((1, SLOT_PORTS)) + 1j * rng.standard_normal((1, SLOT_PORTS))
        w = (w / np.linalg.norm(w)).astype(np.complex64)
        if ue == RETX_UE:
            w = w * np.float32(10 ** (-atten_db / 20))
        sub = pusch.transmit(torch.from_numpy(tb), torch.tensor(rnti), cfg,
                             precoding=torch.from_numpy(w))
        grid[:, :, rb0 * 12 : rb0 * 12 + cfg.nof_grid_sc] += sub
        cfgs.append(cfg)
        tbs.append(tb)
    sigma = np.sqrt(0.5 * 10 ** (-SLOT_SNR_DB / 10))
    rng = np.random.default_rng(100 + noise_seed)
    noise = (rng.standard_normal(grid.shape) + 1j * rng.standard_normal(grid.shape)) * sigma
    return cfgs, tbs, grid + torch.from_numpy(noise.astype(np.complex64))
