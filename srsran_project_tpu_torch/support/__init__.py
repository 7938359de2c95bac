"""Host support modules of the port."""
