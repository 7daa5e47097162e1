"""Frame sources of the port."""
