"""``device_idle_pct.ul``'s reading, in the downlink's cells."""

from portbench.harness.spec import module

read = module("metrics", "device_idle_pct.ul").read
