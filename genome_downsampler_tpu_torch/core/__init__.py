"""The port's read batch."""
