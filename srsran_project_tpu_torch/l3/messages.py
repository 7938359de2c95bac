"""L3 message definitions + typed-JSON wire framing.

Message-surface counterpart of the reference's include/srsran/asn1 RRC /
NGAP / F1AP / E1AP PDU types for the procedures the simulators implement.
Each message is a dataclass registered under a (protocol, name) tag;
encode()/decode() frame it as 1-byte protocol + 1-byte type + JSON body so
messages can cross real byte transports (the SCTP role) deterministically.

A copy of ``srsran_project_tpu/l3/messages.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses
import json

_REGISTRY: dict[tuple[int, int], type] = {}
_TAGS: dict[type, tuple[int, int]] = {}

PROTO_RRC, PROTO_F1AP, PROTO_NGAP, PROTO_E1AP = 0, 1, 2, 3


def msg(proto: int, type_id: int):
    def deco(cls):
        cls = dataclasses.dataclass(frozen=True)(cls)
        _REGISTRY[(proto, type_id)] = cls
        _TAGS[cls] = (proto, type_id)
        return cls
    return deco


# Per-protocol pcap capture hooks — the dlt_pcap role (reference
# lib/pcap/dlt_pcap_impl.cpp): every encoded (tx) frame of an attached
# protocol is written to its writer; rx capture is opt-in so in-process
# loopback links don't record each frame twice.
_PCAPS: dict[int, tuple[object, bool]] = {}


def attach_pcap(proto: int, writer, capture_rx: bool = False) -> None:
    """Attach a support.pcap.PcapWriter to a protocol id (PROTO_* or the
    E2 sim's PROTO_E2AP).  All subsequently encoded frames are captured."""
    _PCAPS[proto] = (writer, capture_rx)


def detach_pcap(proto: int) -> None:
    _PCAPS.pop(proto, None)


def encode(m) -> bytes:
    proto, tid = _TAGS[type(m)]
    body = json.dumps(dataclasses.asdict(m), separators=(",", ":"), sort_keys=True)
    frame = bytes([proto, tid]) + body.encode()
    cap = _PCAPS.get(proto)
    if cap is not None:
        cap[0].write_packet(frame)
    return frame


def decode(data: bytes):
    cls = _REGISTRY[(data[0], data[1])]
    cap = _PCAPS.get(data[0])
    if cap is not None and cap[1]:
        cap[0].write_packet(bytes(data))
    return cls(**json.loads(data[2:].decode()))


# --- RRC (lib/rrc: setup, security, reconfiguration) ------------------------

@msg(PROTO_RRC, 0)
class RrcSetupRequest:
    ue_identity: int  # 39-bit random / 5G-S-TMSI part
    establishment_cause: str = "mo_data"

@msg(PROTO_RRC, 1)
class RrcSetup:
    rnti: int
    srb1_config: dict  # rlc mode etc.

@msg(PROTO_RRC, 2)
class RrcSetupComplete:
    selected_plmn: str
    nas_pdu: str  # hex

@msg(PROTO_RRC, 3)
class RrcSecurityModeCommand:
    ciphering_algo: int  # NEA id
    integrity_algo: int  # NIA id

@msg(PROTO_RRC, 4)
class RrcSecurityModeComplete:
    pass

@msg(PROTO_RRC, 5)
class RrcReconfiguration:
    drb_configs: list  # [{drb_id, qfi, pdcp_sn_bits, rlc_mode, lcid}]
    meas_config: dict | None = None

@msg(PROTO_RRC, 6)
class RrcReconfigurationComplete:
    pass

@msg(PROTO_RRC, 7)
class RrcRelease:
    cause: str = "normal"

@msg(PROTO_RRC, 8)
class RrcReestablishmentRequest:
    rnti: int
    cause: str = "handover_failure"


# --- F1AP (lib/f1ap: DU<->CU-CP) ---------------------------------------------

@msg(PROTO_F1AP, 0)
class F1SetupRequest:
    gnb_du_id: int
    cells: list  # [{pci, nr_cgi, dl_arfcn, bandwidth_rb}]

@msg(PROTO_F1AP, 1)
class F1SetupResponse:
    gnb_cu_name: str
    cells_to_activate: list

@msg(PROTO_F1AP, 2)
class InitialUlRrcMessageTransfer:
    gnb_du_ue_id: int
    c_rnti: int
    rrc_container: str  # hex(encoded RRC msg)

@msg(PROTO_F1AP, 3)
class DlRrcMessageTransfer:
    gnb_du_ue_id: int
    gnb_cu_ue_id: int
    srb_id: int
    rrc_container: str

@msg(PROTO_F1AP, 4)
class UlRrcMessageTransfer:
    gnb_du_ue_id: int
    gnb_cu_ue_id: int
    srb_id: int
    rrc_container: str

@msg(PROTO_F1AP, 5)
class UeContextSetupRequest:
    gnb_cu_ue_id: int
    gnb_du_ue_id: int
    srbs_to_setup: list
    drbs_to_setup: list  # [{drb_id, lcid, rlc_mode, f1u_ul_teid}]

@msg(PROTO_F1AP, 6)
class UeContextSetupResponse:
    gnb_du_ue_id: int
    drbs_setup: list  # [{drb_id, f1u_dl_teid}]

@msg(PROTO_F1AP, 7)
class UeContextReleaseCommand:
    gnb_cu_ue_id: int
    gnb_du_ue_id: int
    cause: str = "normal"

@msg(PROTO_F1AP, 8)
class UeContextReleaseComplete:
    gnb_du_ue_id: int


# --- NGAP (lib/ngap: CU-CP <-> AMF) ------------------------------------------

@msg(PROTO_NGAP, 0)
class NgSetupRequest:
    gnb_id: int
    plmn: str
    tac: int

@msg(PROTO_NGAP, 1)
class NgSetupResponse:
    amf_name: str

@msg(PROTO_NGAP, 2)
class InitialUeMessage:
    ran_ue_id: int
    nas_pdu: str
    establishment_cause: str

@msg(PROTO_NGAP, 3)
class InitialContextSetupRequest:
    ran_ue_id: int
    amf_ue_id: int
    security_key: str  # hex K_gNB
    allowed_nea: list
    allowed_nia: list

@msg(PROTO_NGAP, 4)
class InitialContextSetupResponse:
    ran_ue_id: int
    amf_ue_id: int

@msg(PROTO_NGAP, 5)
class PduSessionResourceSetupRequest:
    ran_ue_id: int
    amf_ue_id: int
    sessions: list  # [{session_id, qfi, ngu_ul_teid, upf_addr}]

@msg(PROTO_NGAP, 6)
class PduSessionResourceSetupResponse:
    ran_ue_id: int
    sessions_setup: list  # [{session_id, ngu_dl_teid}]

@msg(PROTO_NGAP, 7)
class UeContextReleaseRequest:
    ran_ue_id: int
    amf_ue_id: int
    cause: str


# --- E1AP (lib/e1ap: CU-CP <-> CU-UP) ----------------------------------------

@msg(PROTO_E1AP, 0)
class E1SetupRequest:
    gnb_cu_up_id: int

@msg(PROTO_E1AP, 1)
class E1SetupResponse:
    gnb_cu_cp_name: str

@msg(PROTO_E1AP, 2)
class BearerContextSetupRequest:
    gnb_cu_cp_ue_id: int
    security_key: str  # hex
    nea: int
    nia: int
    sessions: list  # [{session_id, qfi, drb_id, pdcp_sn_bits, ngu_ul_teid}]

@msg(PROTO_E1AP, 3)
class BearerContextSetupResponse:
    gnb_cu_cp_ue_id: int
    gnb_cu_up_ue_id: int
    drbs: list  # [{drb_id, f1u_ul_teid, ngu_dl_teid}]

@msg(PROTO_E1AP, 4)
class BearerContextModificationRequest:
    gnb_cu_up_ue_id: int
    drb_f1u_dl_teids: list  # [{drb_id, f1u_dl_teid}] learned from the DU

@msg(PROTO_E1AP, 5)
class BearerContextModificationResponse:
    gnb_cu_up_ue_id: int

@msg(PROTO_E1AP, 6)
class BearerContextReleaseCommand:
    gnb_cu_up_ue_id: int

@msg(PROTO_E1AP, 7)
class BearerContextReleaseComplete:
    gnb_cu_up_ue_id: int


@msg(PROTO_RRC, 9)
class RrcReestablishment:
    next_hop_chaining_count: int = 0

@msg(PROTO_RRC, 10)
class RrcReestablishmentComplete:
    pass


@msg(PROTO_NGAP, 8)
class Paging:
    ue_paging_id: int  # 5G-S-TMSI
    tac_list: list = None


@msg(PROTO_RRC, 11)
class RrcMeasurementReport:
    # [{pci, rsrp_dbm}] — serving cell first
    results: list
