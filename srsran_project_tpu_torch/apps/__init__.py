"""Applications of the port."""
