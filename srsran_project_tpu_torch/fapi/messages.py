"""FAPI-shaped slot command schema: the L2 <-> L1 contract.

Port of ``srsran_project_tpu/fapi/messages.py``: the same dataclasses,
holding the port's config twins.  ``from_reference`` on the four request
messages (``DlTtiRequest``, ``TxDataRequest``, ``UlDciRequest``,
``UlTtiRequest``) copies a request of the JAX package, configs through
their twins' ``from_reference``, so that both packages can be given the
same request.

Mirrors the structure of the reference's SCF-222 message set
(include/srsran/fapi/messages/: dl_tti_request.h, ul_tti_request.h,
tx_data_request.h, crc_indication.h, uci_indication.h, rach_indication.h,
rx_data_indication.h, srs_indication.h, slot_indication.h,
error_indication.h) as Python dataclasses.  PDU "static" geometry reuses
the PHY processor config dataclasses directly (frozen and hashable: the
upper PHY groups equal configs);
dynamic per-slot values (payload bits, RNTIs, precoding) ride alongside.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from ..phy.pdcch import PdcchConfig
from ..phy.pdsch import PdschConfig
from ..phy.prach import PrachConfig
from ..phy.pucch import PucchFormat0Config, PucchFormat1Config
from ..phy.pucch_f2 import PucchFormat2Config
from ..phy.pucch_f34 import PucchFormat34Config
from ..phy.pusch import PuschConfig
from ..phy.srs import SrsConfig
from ..phy.ssb import SsbConfig
from ..ran.constants import SubcarrierSpacing
from ..ran.slot_point import SlotPoint


# Reference config class name -> the port's twin.
_TWINS = {c.__name__: c for c in (PdcchConfig, PdschConfig, PucchFormat0Config,
                                  PucchFormat1Config, PucchFormat2Config, PucchFormat34Config,
                                  PuschConfig, SrsConfig, SsbConfig, PrachConfig)}


def _twin(ref):
    """The port's twin of a reference config (a config without one stays
    as it is)."""
    cls = _TWINS.get(type(ref).__name__)
    if cls is None:
        return ref
    if hasattr(cls, "from_reference"):
        return cls.from_reference(ref)
    return cls(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)})


def _slot(ref) -> SlotPoint:
    return SlotPoint(SubcarrierSpacing(int(ref.scs)), int(ref.count))


def _pdus(cls, refs, **convert) -> list:
    """Copy reference PDUs field by field: ``config`` through its twin,
    arrays as numpy copies, the fields named in ``convert`` through their
    function."""
    out = []
    for ref in refs:
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(ref, f.name)
            if f.name in convert:
                v = convert[f.name](v)
            elif f.name == "config":
                v = _twin(v)
            elif hasattr(v, "shape"):
                v = np.array(v)
            kw[f.name] = v
        out.append(cls(**kw))
    return out


# --------------------------------------------------------------------------
# Downlink requests
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DlPdschPdu:
    config: PdschConfig
    rnti: int
    precoding: np.ndarray  # (layers, ports) complex64
    tb_index: int  # index into TxDataRequest.payloads
    # Dynamic frequency placement: when set, `config` describes a compact
    # rb_start=0 grid of alloc.rb_count PRBs and the PDU is placed at this
    # PRB offset with a dynamic slice — so equal-size grants of different
    # UEs share one compiled program.
    first_rb: int | None = None


@dataclasses.dataclass
class DlPdcchPdu:
    config: PdcchConfig
    rnti: int
    payload: np.ndarray  # DCI bits


@dataclasses.dataclass
class DlSsbPdu:
    config: SsbConfig
    payload: np.ndarray  # 32 PBCH payload bits
    first_subcarrier: int  # SSB placement in the grid
    first_symbol: int


@dataclasses.dataclass
class DlCsiRsPdu:
    row: int  # CSI-RS resource mapping row (1 = single port density 3)
    rb_start: int
    rb_count: int
    symbol: int
    scrambling_id: int


@dataclasses.dataclass
class DlTtiRequest:
    slot: SlotPoint
    pdsch: Sequence[DlPdschPdu] = ()
    pdcch: Sequence[DlPdcchPdu] = ()
    ssb: Sequence[DlSsbPdu] = ()
    csi_rs: Sequence[DlCsiRsPdu] = ()

    @classmethod
    def from_reference(cls, ref) -> "DlTtiRequest":
        return cls(slot=_slot(ref.slot), pdsch=_pdus(DlPdschPdu, ref.pdsch),
                   pdcch=_pdus(DlPdcchPdu, ref.pdcch), ssb=_pdus(DlSsbPdu, ref.ssb),
                   csi_rs=_pdus(DlCsiRsPdu, ref.csi_rs))


@dataclasses.dataclass
class UlDciRequest:
    """UL_DCI.request: PDCCH PDUs carrying UL grants, transmitted in the
    DL direction outside a DL_TTI.request (SCF-222 §3.4.4,
    include/srsran/fapi/messages/ul_dci_request.h)."""

    slot: SlotPoint
    pdcch: Sequence[DlPdcchPdu] = ()

    @classmethod
    def from_reference(cls, ref) -> "UlDciRequest":
        return cls(slot=_slot(ref.slot), pdcch=_pdus(DlPdcchPdu, ref.pdcch))


@dataclasses.dataclass
class TxDataRequest:
    slot: SlotPoint
    payloads: Sequence[np.ndarray] = ()  # TB bit arrays, indexed by tb_index

    @classmethod
    def from_reference(cls, ref) -> "TxDataRequest":
        return cls(slot=_slot(ref.slot), payloads=[np.array(p) for p in ref.payloads])


# --------------------------------------------------------------------------
# Uplink requests
# --------------------------------------------------------------------------

@dataclasses.dataclass
class UlPuschPdu:
    config: PuschConfig
    rnti: int
    harq_id: int = 0
    new_data: bool = True
    first_rb: int | None = None  # see DlPdschPdu.first_rb


@dataclasses.dataclass
class UlPucchPdu:
    config: Any  # PucchFormat0Config | PucchFormat1Config | PucchFormat2Config
    rnti: int


@dataclasses.dataclass
class UlPrachPdu:
    config: PrachConfig


@dataclasses.dataclass
class UlSrsPdu:
    config: SrsConfig
    rnti: int


@dataclasses.dataclass
class UlTtiRequest:
    slot: SlotPoint
    pusch: Sequence[UlPuschPdu] = ()
    pucch: Sequence[UlPucchPdu] = ()
    prach: Sequence[UlPrachPdu] = ()
    srs: Sequence[UlSrsPdu] = ()

    @classmethod
    def from_reference(cls, ref) -> "UlTtiRequest":
        return cls(slot=_slot(ref.slot), pusch=_pdus(UlPuschPdu, ref.pusch),
                   pucch=_pdus(UlPucchPdu, ref.pucch), prach=_pdus(UlPrachPdu, ref.prach),
                   srs=_pdus(UlSrsPdu, ref.srs))


# --------------------------------------------------------------------------
# Indications (PHY -> MAC)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CrcIndicationPdu:
    rnti: int
    harq_id: int
    tb_crc_ok: bool
    # Post-equalization SINR measured on this PUSCH (drives closed-loop
    # power control; reference crc_indication.ul_sinr_metric).
    snr_db: float | None = None
    # Estimator time alignment in seconds (drives the scheduler's TA
    # maintenance loop; reference crc_indication.time_advance_offset).
    ta_s: float | None = None


@dataclasses.dataclass
class RxDataIndicationPdu:
    rnti: int
    harq_id: int
    payload: np.ndarray


@dataclasses.dataclass
class UciIndicationPdu:
    rnti: int
    uci_bits: np.ndarray
    valid: bool
    metric: float


@dataclasses.dataclass
class RachIndicationPdu:
    preamble_index: int
    metric: float
    ta_samples: float


class SrsReportType:
    """SRS report types (reference srs_pdu_report_type.h:31)."""

    PER_PRG_AND_SYMBOL_SNR = 0
    NORMALIZED_CHANNEL_IQ_MATRIX = 1
    CHANNEL_SVD = 2
    POSITIONING = 3
    SU_MIMO_CODEBOOK = 4
    CHANNEL_2D_DFT = 5
    SU_MIMO_CODEBOOK_V2 = 6
    PER_PRG_NI_AND_RSRP = 7
    NO_REPORT = 255


@dataclasses.dataclass
class SrsIndicationPdu:
    rnti: int
    snr_db: float
    phase_slope: float  # wideband delay indicator (radians per comb step)
    h: np.ndarray  # (ports, seq_length) channel estimate
    report_type: int = SrsReportType.NORMALIZED_CHANNEL_IQ_MATRIX


@dataclasses.dataclass
class SlotIndication:
    slot: SlotPoint


@dataclasses.dataclass
class ErrorIndication:
    slot: SlotPoint
    message: str
    error_code: int = 0x4  # ErrorCode.MSG_SLOT_ERR default
    message_id: int = 0


class ErrorCode:
    """FAPI error codes (reference include/srsran/fapi/messages/error_code.h:31)."""

    MSG_OK = 0x0
    MSG_INVALID_STATE = 0x1
    MSG_INVALID_CONFIG = 0x2
    OUT_OF_SYNC = 0x3
    MSG_SLOT_ERR = 0x4
    MSG_BCH_MISSING = 0x5
    MSG_INVALID_SFN = 0x6
    MSG_UL_DCI_ERR = 0x7
    MSG_TX_ERR = 0x8
    MSG_INVALID_PHY_ID = 0x9
    MSG_UNINSTANTIATED_PHY = 0xA
    MSG_INVALID_DFE_PROFILE = 0xB
    PHY_PROFILE_INCOMPATIBLE_RUNNING_PHY = 0xC


@dataclasses.dataclass
class DlTtiResponsePdu:
    """Per-PDU CW/TB acknowledgment (dl_tti_response.h:31)."""

    handle: int
    status: int  # ErrorCode


@dataclasses.dataclass
class DlTtiResponse:
    slot: SlotPoint
    pdus: Sequence[DlTtiResponsePdu] = ()


# --------------------------------------------------------------------------
# Configuration procedure messages (config_messages.h)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ParamRequest:
    protocol_version: int = 222


@dataclasses.dataclass
class ParamResponse:
    error_code: int = ErrorCode.MSG_OK
    # Capability TLVs: practical subset (the reference carries SCF-222
    # param TLV structs, param_request_tlvs.h).
    max_nof_prb: int = 275
    supported_scs_khz: tuple = (15, 30, 60, 120)
    max_nof_tx_ports: int = 4
    max_nof_rx_ports: int = 4
    supports_tdd: bool = True


@dataclasses.dataclass
class ConfigRequest:
    scs_khz: int
    nof_prb: int
    nof_tx_ports: int
    nof_rx_ports: int
    cp_normal: bool = True
    pci: int = 1
    prach_config_index: int = 0
    tdd_pattern: Any = None


@dataclasses.dataclass
class ConfigResponse:
    error_code: int = ErrorCode.MSG_OK


@dataclasses.dataclass
class StartRequest:
    pass


@dataclasses.dataclass
class StartResponse:
    pass


@dataclasses.dataclass
class StopRequest:
    pass


@dataclasses.dataclass
class StopIndication:
    pass


@dataclasses.dataclass
class SlotResults:
    slot: SlotPoint
    crc: list = dataclasses.field(default_factory=list)
    rx_data: list = dataclasses.field(default_factory=list)
    uci: list = dataclasses.field(default_factory=list)
    rach: list = dataclasses.field(default_factory=list)
    srs: list = dataclasses.field(default_factory=list)
    errors: list = dataclasses.field(default_factory=list)
