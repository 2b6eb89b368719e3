"""Framework utilities of the port (tree helpers)."""
