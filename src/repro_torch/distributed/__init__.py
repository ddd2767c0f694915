"""Cross-device pieces of the port (the global screen's table merge)."""
