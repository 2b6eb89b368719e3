"""Data sources of the port's trainer."""
