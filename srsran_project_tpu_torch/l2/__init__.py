"""The L2 protocol stack of the port: the MAC PDU codecs (``mac_pdu``),
RLC, PDCP, SDAP, GTP-U, NR-U, security, and the CU-UP and DU-high
simulators that chain them.

Copies of the JAX package's ``l2/`` modules (none of them imports JAX),
each held equal to the reference by the port's tests.  Host-side byte
logic: the transport blocks they build cross to the PHY as numpy bit
arrays at the FAPI boundary.
"""
