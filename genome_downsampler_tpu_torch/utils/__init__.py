"""Logging and timers of the port."""
