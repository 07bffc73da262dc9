"""The card's peaks and the least bytes a selection kernel must move.

A kernel's roofline share is the least time the card could take for the
sample's work over the time the kernel took. The work is counted from the
sample's inputs alone, never from the rounds, supersteps or arcs an
implementation walks: each read's fields and each base's target read once
from device memory, and one bit a read for the selection written once. So
no implementation can read above 100%, and the share reads very small.
"""

from __future__ import annotations

# HBM bandwidth of each card, by ``torch.cuda.get_device_name()``, from
# NVIDIA's H100 data sheet (the SXM part); the rate assumes the card's
# full power limit, so a share is stated beside that limit
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

TARGET_BYTES = 4  # int32 per base
SELECTION_BITS = 1  # per read


def selection_bytes(reads: int, genome_length: int, field_bytes: int) -> float:
    """Bytes a kernel must move for one sample: ``field_bytes`` of each
    read's fields and the target of each base read once, one bit a read
    written once."""
    return reads * field_bytes + genome_length * TARGET_BYTES + reads * SELECTION_BITS / 8


def least_seconds(kind: str, nbytes: float) -> float | None:
    """The least time the card ``kind`` takes to move ``nbytes``, or None
    for a card the table lacks."""
    peak = PEAK_BYTES_PER_S.get(kind)
    return None if peak is None else nbytes / peak
