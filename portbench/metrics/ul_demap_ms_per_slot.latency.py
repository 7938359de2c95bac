"""``ul_demap_ms_per_slot``'s reading, in the cells whose per-layer metrics move
``ul_slot_p95_ms``."""

from portbench.harness.spec import module

read = module("metrics", "ul_demap_ms_per_slot").read
