"""L3 control plane: RRC / F1AP / NGAP / E1AP procedure simulators.

Scope-parity counterpart of the reference's lib/cu_cp, lib/rrc, lib/ngap,
lib/f1ap, lib/e1ap (SURVEY.md section 2.4) at interface/simulator fidelity
(SURVEY section 1): the procedure state machines and message flows are
real (setup, UE attach, security mode, bearer establishment, release);
the wire encoding is a compact typed-JSON framing instead of ASN.1 PER
(the reference's 502 kLoC generated codecs are out of scope by design —
both endpoints in this framework speak the same framing, as the
reference's in-process connectors do for the monolithic gnb).

Copies of the JAX package's ``l3/`` modules, held equal to them by the
port's tests; mobility is a mixin of ``CuCpSim`` (``mobility.py``).
"""
