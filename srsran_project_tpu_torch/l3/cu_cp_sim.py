"""CU-CP / AMF / DU-F1 control-plane simulators.

Procedure-level counterpart of the reference's lib/cu_cp (ue_manager,
rrc_ue procedures, ngap client, f1ap CU side, e1ap CU-CP side) per
SURVEY.md section 2.4: the full UE attach choreography —

  DU: InitialUlRrcMessageTransfer(RrcSetupRequest)
  CU-CP: RrcSetup  ->  UE: RrcSetupComplete(NAS)
  CU-CP -> AMF: InitialUeMessage
  AMF: InitialContextSetupRequest(K_gNB)  ->  CU-CP: SecurityModeCommand
  UE: SecurityModeComplete  (SRB1 PDCP integrity+ciphering activates,
      keys derived per TS 33.501 A.8 from K_gNB)
  AMF: PduSessionResourceSetupRequest
  CU-CP -> CU-UP: E1 BearerContextSetup (keys, NEA/NIA, TEIDs)
  CU-CP -> DU:   F1 UeContextSetup (DRB + F1-U UL TEID)
  CU-CP -> CU-UP: E1 BearerContextModification (F1-U DL TEID from DU)
  CU-CP -> UE:   RrcReconfiguration(DRB)  ->  Complete
  CU-CP -> AMF:  PduSessionResourceSetupResponse

plus UE release.  Transport links are byte callables carrying the typed-
JSON framing (messages.py) — the SCTP role.  RRC containers between CU-CP
and the UE ride F1AP RRC message transfers; after security activation they
are protected by real PDCP SRB entities (12-bit SN) using the l2 security
engines.

A copy of ``srsran_project_tpu/l3/cu_cp_sim.py``; the mobility procedures
need no import here, since they are methods of ``CuCpSim``'s base
(``mobility.MobilityMixin``).
"""

# One module per reference subsystem; this module is the import surface.
from .amf_sim import AmfSim  # noqa: F401
from .cu_cp import CuCpSim  # noqa: F401
from .cu_up_e1 import CuUpE1Agent  # noqa: F401
from .du_f1 import DuF1Sim  # noqa: F401
from .rrc import CuUeCtx, _CuUeCtx, make_srb_pdcp  # noqa: F401
