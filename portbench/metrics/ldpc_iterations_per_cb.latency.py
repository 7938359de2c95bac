"""``ldpc_iterations_per_cb``'s reading, in the cells whose per-layer metrics move
``ul_slot_p95_ms``."""

from portbench.harness.spec import module

read = module("metrics", "ldpc_iterations_per_cb").read
