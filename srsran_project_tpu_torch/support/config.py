"""YAML-backed configuration of the DU-low.

Port of ``srsran_project_tpu/support/config.py`` (the reference's CLI11 +
YAML config machinery, apps/units/flexible_o_du/o_du_low/du_low_config.h):
dataclass-schema configs loaded from YAML with dotted-path overrides,
validation, round-trip dumping, ``to_cell_config``, which returns the
port's ``CellConfig``, and ``to_scheduler_config``, which returns the
port's ``l2sim.scheduler.SchedulerConfig``.  PyYAML is imported only by ``load_config`` with a
path and by ``dump_config``: the defaults and the overrides need no YAML.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..ops.modulation import Modulation
from ..ran.constants import CyclicPrefix, SubcarrierSpacing


@dataclasses.dataclass
class ExpertPhyConfig:
    """Expert upper-PHY knobs (reference: du_low_config.h:33-170)."""

    max_processing_delay_slots: int = 5
    pusch_max_nof_ldpc_iterations: int = 6
    ldpc_decoder_early_stop: bool = True  # syndrome early stop per codeblock
    pusch_sinr_calc_method: str = "post_equalization"
    pusch_channel_estimator_fd_strategy: str = "filter"  # none | mean | filter
    pusch_channel_estimator_td_strategy: str = "average"
    pusch_channel_estimator_cfo_compensation: bool = False
    pusch_channel_equalizer_algorithm: str = "mmse"  # zf | mmse
    pdsch_processor_type: str = "flexible"
    pdsch_cb_batch_length: int = 0  # 0 = whole codeword batch
    llr_range_limit: float = 20.0
    # Kernel parity selections (conformance mode): reference-exact int8
    # demapper / int8 layered min-sum decoder instead of the float path.
    pusch_demapper: str = "float"  # float | reference
    pusch_decoder_kernel: str = "auto"  # auto | reference_i8
    pusch_noise_estimator: str = "second_difference"  # | pair_residual
    # Dump received resource-grid symbols to this file-prefix per slot
    # (reference phy_rx_symbols_filename knob); empty = off.
    phy_rx_symbols_filename: str = ""


@dataclasses.dataclass
class CellYamlConfig:
    nof_rb: int = 273
    scs_khz: int = 30
    cyclic_prefix: str = "normal"
    nof_ports: int = 4
    nof_layers: int = 4
    modulation: str = "qam256"
    target_code_rate: float = 948.0 / 1024.0
    f_center_hz: float = 3.5e9
    pci: int = 1


@dataclasses.dataclass
class SchedulerYamlConfig:
    """MAC scheduler knobs (reference: du_high cell/scheduler expert args;
    mapped onto l2sim.scheduler.SchedulerConfig)."""

    policy: str = "rr"  # rr | qos
    max_ues_per_slot: int = 4
    max_nof_ues: int = 32
    use_pdcch_alloc: bool = False
    use_pucch_alloc: bool = False
    use_srs: bool = False
    k1: int = 4
    ul_demand_driven: bool = False
    # TDD pattern (None entries = FDD): e.g. 7 DL / 2 UL in a 10-slot period.
    tdd_period_slots: int = 0  # 0 = FDD
    tdd_dl_slots: int = 0
    tdd_ul_slots: int = 0


@dataclasses.dataclass
class NtnConfig:
    """Non-terrestrial-network cell parameters (reference:
    include/srsran/ntn/ntn_configuration_manager.h, configs/geo_ntn.yml).

    The scheduler offsets every UL-grant / HARQ-feedback timing relation by
    cell_specific_koffset slots, and ta_common_ms pre-compensates the bulk
    round-trip delay (GEO ~ 240-270 ms) before per-UE TA tracking."""

    enabled: bool = False
    cell_specific_koffset: int = 0  # slots added to k1/k2 timing relations
    ta_common_ms: float = 0.0  # broadcast common timing advance
    ta_common_drift_us_per_s: float = 0.0
    ephemeris: dict | None = None  # position/velocity state vector (opaque)


@dataclasses.dataclass
class DuLowConfig:
    cell: CellYamlConfig = dataclasses.field(default_factory=CellYamlConfig)
    expert_phy: ExpertPhyConfig = dataclasses.field(default_factory=ExpertPhyConfig)
    scheduler: SchedulerYamlConfig = dataclasses.field(default_factory=SchedulerYamlConfig)
    ntn: NtnConfig = dataclasses.field(default_factory=NtnConfig)
    log_level: str = "info"


_MOD_MAP = {
    "pi2bpsk": Modulation.PI_2_BPSK,
    "bpsk": Modulation.BPSK,
    "qpsk": Modulation.QPSK,
    "qam16": Modulation.QAM16,
    "qam64": Modulation.QAM64,
    "qam256": Modulation.QAM256,
}
_SCS_MAP = {15: SubcarrierSpacing.KHZ15, 30: SubcarrierSpacing.KHZ30, 60: SubcarrierSpacing.KHZ60,
            120: SubcarrierSpacing.KHZ120, 240: SubcarrierSpacing.KHZ240}


def _from_dict(cls, d: dict):
    import typing

    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = hints.get(f.name, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            v = _from_dict(ftype, v)
        kwargs[f.name] = v
    return cls(**kwargs)


def load_config(path: str | None = None, overrides: dict[str, Any] | None = None) -> DuLowConfig:
    """Load YAML + apply dotted-path overrides (e.g. {"cell.nof_rb": 52})."""
    data: dict = {}
    if path:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
    cfg = _from_dict(DuLowConfig, data)
    for key, value in (overrides or {}).items():
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        if not hasattr(obj, parts[-1]):
            raise KeyError(key)
        setattr(obj, parts[-1], value)
    validate(cfg)
    return cfg


def validate(cfg: DuLowConfig) -> None:
    c = cfg.cell
    if not 1 <= c.nof_rb <= 275:
        raise ValueError(f"nof_rb {c.nof_rb} out of range")
    if c.scs_khz not in _SCS_MAP:
        raise ValueError(f"invalid scs {c.scs_khz}")
    if c.modulation not in _MOD_MAP:
        raise ValueError(f"invalid modulation {c.modulation}")
    if c.nof_layers > c.nof_ports:
        raise ValueError("nof_layers > nof_ports")
    if not 0.0 < c.target_code_rate < 1.0:
        raise ValueError("target_code_rate out of range")
    e = cfg.expert_phy
    if e.pusch_channel_equalizer_algorithm not in ("zf", "mmse", "zf_ref", "mmse_ref"):
        raise ValueError(e.pusch_channel_equalizer_algorithm)
    if e.pusch_demapper not in ("float", "reference"):
        raise ValueError(e.pusch_demapper)
    if e.pusch_decoder_kernel not in ("auto", "reference_i8"):
        raise ValueError(e.pusch_decoder_kernel)
    s = cfg.scheduler
    if s.policy not in ("rr", "qos"):
        raise ValueError(s.policy)
    if s.tdd_period_slots and s.tdd_dl_slots + s.tdd_ul_slots > s.tdd_period_slots:
        raise ValueError("TDD pattern exceeds period")


def dump_config(cfg: DuLowConfig) -> str:
    """Round-trip the config to YAML (the reference's --dump_config)."""
    import yaml

    return yaml.safe_dump(dataclasses.asdict(cfg), sort_keys=False)


def to_cell_config(cfg: DuLowConfig):
    """Build the runtime CellConfig from the YAML schema."""
    from ..models.cell import CellConfig

    c = cfg.cell
    e = cfg.expert_phy
    return CellConfig(
        nof_rb=c.nof_rb,
        scs=_SCS_MAP[c.scs_khz],
        cp=CyclicPrefix.NORMAL if c.cyclic_prefix == "normal" else CyclicPrefix.EXTENDED,
        nof_ports=c.nof_ports,
        nof_layers=c.nof_layers,
        modulation=_MOD_MAP[c.modulation],
        target_code_rate=c.target_code_rate,
        f_center_hz=c.f_center_hz,
        nof_ldpc_iterations=e.pusch_max_nof_ldpc_iterations,
        ldpc_early_stop=e.ldpc_decoder_early_stop,
        equalizer=e.pusch_channel_equalizer_algorithm,
        sinr_method=("post_equalization"
                     if e.pusch_sinr_calc_method == "post_equalization"
                     else "channel_estimator"),
        cfo_compensation=e.pusch_channel_estimator_cfo_compensation,
        llr_range_limit=e.llr_range_limit,
        demapper=e.pusch_demapper,
        ldpc_decoder=e.pusch_decoder_kernel,
        noise_method=e.pusch_noise_estimator,
    )


def to_scheduler_config(cfg: DuLowConfig, nof_grid_sc: int | None = None):
    """Build the l2sim SchedulerConfig from the YAML schema."""
    from ..l2sim.scheduler import SchedulerConfig
    from ..ran.tdd import TddPattern

    s = cfg.scheduler
    tdd = None
    if s.tdd_period_slots:
        tdd = TddPattern(period_slots=s.tdd_period_slots,
                         nof_dl_slots=s.tdd_dl_slots, nof_ul_slots=s.tdd_ul_slots)
    return SchedulerConfig(
        nof_grid_sc=nof_grid_sc or cfg.cell.nof_rb * 12,
        nof_rb=cfg.cell.nof_rb,
        max_ues_per_slot=s.max_ues_per_slot,
        nof_layers=cfg.cell.nof_layers,
        nof_ports=cfg.cell.nof_ports,
        tdd_pattern=tdd,
        policy=s.policy,
        ul_demand_driven=s.ul_demand_driven,
        ntn_koffset=cfg.ntn.cell_specific_koffset,
        use_pdcch_alloc=s.use_pdcch_alloc,
        use_pucch_alloc=s.use_pucch_alloc,
        use_srs=s.use_srs,
        k1=s.k1,
    )
