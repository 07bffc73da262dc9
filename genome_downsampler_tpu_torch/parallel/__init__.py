"""Parallel decompositions of the sweep: genome windows on one card."""
