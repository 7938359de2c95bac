"""The L2 protocol stack of the port: so far the MAC PDU codecs (``mac_pdu``)."""
