"""Open Fronthaul (split 7.2) host-side subsystem.

Port of ``srsran_project_tpu/ofh`` (the reference's lib/ofh): the
eCPRI/ORAN C+U-plane serdes and BFP compression live in native C++
(``srsran_project_tpu_torch/native/``, bound by ``support.native``); this
package adds the Ethernet/VLAN framing and the receiver-side protections
(rx window checker, sequence-id checker) and the realtime slot ticker.
All of it is host code; DPDK and NIC I/O are out of scope, and the UDP IQ
transport stands in for the wire.
"""
