"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; arrays
cross between JAX and torch as numpy arrays.
"""

import dataclasses
import enum
import functools
import sys
import types

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


def plain(x):
    """x as plain, package-independent data: a dataclass or another object
    with attributes as its class name and fields, an enum by value, an
    array with its dtype and shape; containers element by element."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tolist())
    if isinstance(x, np.generic):
        return (str(x.dtype), x.item())
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(plain(v) for v in x))
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if hasattr(x, "__dict__") and not isinstance(x, type) and not callable(x):
        return (type(x).__name__, plain(vars(x)))
    return x


def plain_state(x):
    """plain(x) for an object graph that holds callbacks: every function,
    method or lambda (they differ by package) reads as "<callable>"."""
    if isinstance(x, (types.FunctionType, types.MethodType, types.BuiltinFunctionType,
                      functools.partial)):
        return "<callable>"
    if isinstance(x, (enum.Enum, np.ndarray, np.generic)):
        return plain(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain_state(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {plain_state(k): plain_state(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(plain_state(v) for v in x))
    if isinstance(x, (list, tuple)):
        return [plain_state(v) for v in x]
    if hasattr(x, "__dict__") and not isinstance(x, type):
        return (type(x).__name__, plain_state(vars(x)))
    return x


def reference_cases(module, skip=()):
    """pytest params (module, test name, kwargs) for every test function
    defined in the reference's test ``module``, one per combination of its
    ``parametrize`` marks; for ``run_on_port``."""
    cases = []
    for name, fn in vars(module).items():
        if (not name.startswith("test_") or not isinstance(fn, types.FunctionType)
                or fn.__module__ != module.__name__ or name in skip):
            continue
        combos = [{}]
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            names = [a.strip() for a in mark.args[0].split(",")]
            values = [v.values if hasattr(v, "values") else v if len(names) > 1 else (v,)
                      for v in mark.args[1]]
            combos = [{**c, **dict(zip(names, v))} for c in combos for v in values]
        for i, kw in enumerate(combos):
            tag = f"{module.__name__}.{name}" + (f"[{i}]" if len(combos) > 1 else "")
            cases.append(pytest.param(module, name, kw, id=tag))
    return cases


def run_on_port(monkeypatch, module, name: str, kwargs: dict, swaps: dict,
                also=(), modules=None) -> None:
    """Run the reference's test ``module.name(**kwargs)`` with the globals
    named in ``swaps`` of ``module`` (and of the test modules in ``also``,
    whose helpers it calls) replaced by the port's objects, and the
    ``sys.modules`` entries in ``modules`` (imports inside its functions)
    by the port's modules; no global of those test modules may still name
    the JAX package's l2, l3, l2sim or units."""
    for mod in (module, *also):
        for attr, obj in swaps.items():
            if hasattr(mod, attr):
                monkeypatch.setattr(mod, attr, obj)
        left = sorted(k for k, v in vars(mod).items()
                      if (getattr(v, "__module__", None) or getattr(v, "__name__", "")).startswith(
                          ("srsran_project_tpu.l2", "srsran_project_tpu.l3",
                           "srsran_project_tpu.units")))
        assert not left, (mod.__name__, left)
    for name_, mod in (modules or {}).items():
        monkeypatch.setitem(sys.modules, name_, mod)
    getattr(module, name)(**kwargs)


@pytest.fixture
def cuda_device() -> torch.device:
    """The GPU for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# ---- host runtime: the reference's native library, a fake clock ------------

@pytest.fixture(scope="module")
def ref_native():
    """The JAX package's native module with its library loaded.  Its
    ``get_lib`` runs ``make -C native`` in every test worker and gives up
    for good (None) when it reads a library another worker is still
    linking: let it look again until the link is done."""
    import time

    from srsran_project_tpu.support import native as jnative

    for _ in range(100):
        if jnative.get_lib() is not None:
            return jnative
        jnative._TRIED = False
        time.sleep(0.2)
    pytest.fail("the JAX package's native library did not build")


class FakeClock:
    """Stands in for the ``time`` module of a port module: ``monotonic``
    reads a counter.  ``sleep`` advances it (``advance``), or leaves it to
    the test; either way it yields the interpreter for ``yield_s`` real
    seconds, so that other threads run.  A paced loop then goes the same
    way under any load."""

    def __init__(self, t0: float = 100.0, advance: bool = True, yield_s: float = 0.0):
        import time

        self.t = t0
        self.advance = advance
        self.yield_s = yield_s
        self.sleeps = 0
        self._real_sleep = time.sleep

    def monotonic(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.sleeps += 1
        if self.advance:
            self.t += dt
        if self.yield_s:
            self._real_sleep(self.yield_s)


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


# ---- one grant of any allocation shape and waveform ------------------------

def grant_configs(nof_rb=12, layers=1, ports=2, modulation=4, rate=0.5, dmrs_type=1,
                  cdm_without_data=2, dmrs_symbols=(2,), sym_start=0, sym_count=14,
                  rb_start=0, crb_start=0, equalizer="mmse", **extra):
    """(JAX PdschConfig of the UE side, JAX PuschConfig) of one grant; the
    port's twins come from ``from_reference``.  ``modulation`` is the
    reference's Modulation value (0 = pi/2-BPSK); ``extra`` sets the PT-RS
    and transform-precoding fields of both."""
    from srsran_project_tpu.ops.modulation import Modulation
    from srsran_project_tpu.phy import pdsch, pusch
    from srsran_project_tpu.phy.allocation import Allocation
    from srsran_project_tpu_torch.ran import tbs as tbs_mod

    mod = Modulation(modulation)
    alloc = Allocation(rb_start=rb_start, rb_count=nof_rb, sym_start=sym_start,
                       sym_count=sym_count, dmrs_symbols=tuple(dmrs_symbols),
                       dmrs_config_type=dmrs_type,
                       nof_cdm_groups_without_data=cdm_without_data, crb_start=crb_start)
    qm = 1 if mod == Modulation.PI_2_BPSK else int(mod)
    common = dict(tbs=tbs_mod.calculate_tbs(nof_rb, sym_count, 12 * len(dmrs_symbols), rate,
                                            qm, layers),
                  target_code_rate=rate, modulation=mod, alloc=alloc, nof_layers=layers,
                  nof_grid_symbols=14, nof_grid_sc=(rb_start + nof_rb) * 12, slot_in_frame=3,
                  n_id=7, dmrs_scrambling_id=11, **extra)
    return (pdsch.PdschConfig(nof_ports=layers, **common),
            pusch.PuschConfig(nof_rx_ports=ports, equalizer=equalizer, **common))


def unit_channel(rng, layers: int, ports: int) -> np.ndarray:
    """(layers, ports) complex64: orthonormal rows scaled to unit power a
    port (a random unitary matrix when layers == ports)."""
    h = rng.standard_normal((ports, layers)) + 1j * rng.standard_normal((ports, layers))
    return (np.linalg.qr(h)[0].T * np.sqrt(ports / layers)).astype(np.complex64)


def loopback(jtx, jrx, seed: int = 0, snr_db: float = 30.0, phase_noise: float = 0.0,
             channel=None):
    """One grant over the air: the port's ``pdsch.process`` (the UE side)
    with the twin of ``jtx``, through a random channel (``unit_channel``
    unless given, (layers, ports)), with a random common phase per symbol
    of up to +-``phase_noise`` rad (none on the DM-RS symbols) and AWGN at
    ``snr_db`` a port.  Returns (TB bits, RNTI, received (P, 14, nsc)
    complex64), all numpy."""
    from srsran_project_tpu_torch.phy import pdsch as tpdsch

    rng = np.random.default_rng(seed)
    ttx = tpdsch.PdschConfig.from_reference(jtx)
    tb = rng.integers(0, 2, size=(ttx.tbs,), dtype=np.uint8)
    rnti = 0x4601 + seed
    w = unit_channel(rng, ttx.nof_layers, jrx.nof_rx_ports) if channel is None else channel
    rx = to_np(tpdsch.process(torch.from_numpy(tb), rnti, torch.from_numpy(w), ttx))
    if phase_noise:
        ph = rng.uniform(-phase_noise, phase_noise, 14)
        ph[list(ttx.alloc.dmrs_symbols)] = 0.0
        rx = rx * np.exp(1j * ph)[None, :, None]
    sigma = np.sqrt(0.5 * 10 ** (-snr_db / 10))
    rx = rx + sigma * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    return tb, rnti, rx.astype(np.complex64)


def assert_llr_gate(llr_j, llr_t, what=""):
    """int8 LLRs within +-1 everywhere and equal on >= 99.9 % of positions
    (ROADMAP Q3)."""
    d = np.abs(np.asarray(llr_j).astype(np.int32) - np.asarray(llr_t).astype(np.int32))
    assert d.max() <= 1, (what, int(d.max()))
    assert (d == 0).mean() >= 0.999, (what, float((d == 0).mean()))


def process_parity(jrx, rx, rnti, tb):
    """The JAX package's and the port's ``pusch.process`` (and front end)
    on one received grid: the LLR gate, TB bits and CRC equal to each other
    and to the sent TB.  Returns (JAX result, port result) as numpy dicts."""
    import jax.numpy as jnp

    from srsran_project_tpu.phy import pusch as jpusch
    from srsran_project_tpu_torch.phy import pusch as tpusch

    trx = tpusch.PuschConfig.from_reference(jrx)
    gj, gt = jnp.asarray(rx), torch.from_numpy(rx)[None]
    llr_j = np.asarray(jpusch._front_end(gj, jnp.uint32(rnti), jrx)[0])
    llr_t = to_np(tpusch._front_end(gt, torch.tensor([rnti]), trx)[0][0])
    assert_llr_gate(llr_j, llr_t)
    res_j = {k: np.asarray(v) for k, v in jpusch.process(gj, jnp.uint32(rnti), jrx).items()}
    res_t = {k: to_np(v[0]) for k, v in tpusch.process(gt, torch.tensor([rnti]), trx).items()}
    assert bool(res_j["tb_crc_ok"]) and bool(res_t["tb_crc_ok"])
    np.testing.assert_array_equal(res_t["tb_bits"], tb)
    np.testing.assert_array_equal(res_j["tb_bits"], tb)
    assert abs(float(res_j["snr_db"]) - float(res_t["snr_db"])) <= 1e-3
    return res_j, res_t
