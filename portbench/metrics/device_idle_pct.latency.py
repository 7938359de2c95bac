"""``device_idle_pct.ul``'s reading, in the cells whose per-layer metrics move
``ul_slot_p95_ms``."""

from portbench.harness.spec import module

read = module("metrics", "device_idle_pct.ul").read
