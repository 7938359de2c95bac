"""``ldpc_decode_roofline_pct``'s reading, in the cells whose per-layer metrics move
``ul_slot_p95_ms``."""

from portbench.harness.spec import module

read = module("metrics", "ldpc_decode_roofline_pct").read
