"""Solvers of the port and its registry."""
