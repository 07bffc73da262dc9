"""Synthetic reads, in-memory BAM writer and coverage tester of the port."""
