"""``ul_host_ms_per_slot``'s reading, in the downlink's cells."""

from portbench.harness.spec import module

read = module("metrics", "ul_host_ms_per_slot").read
