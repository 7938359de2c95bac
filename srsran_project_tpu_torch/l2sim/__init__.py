"""The L2 scheduler simulator of the port: the slot scheduler, its allocators and loops."""
