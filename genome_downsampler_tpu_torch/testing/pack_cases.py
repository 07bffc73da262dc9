"""The pack kernel's card cases (``ops/device_pack.py``, ``csrc/device_pack.cu``).

``PACK_CASES`` are ``(reads, genome, W, block, max_span, cap)`` with 150-bp
reads: config-5's geometry at 60x and at 225x with a deeper cap (one thread
a position over its whole candidate range), then small genomes, where the
kernel splits each position's candidates over threads and over the CTAs of
a cluster: 10,000 bases (windows ending mid-block), 8,192 bases in two
windows that end where the genome does (``diff``'s last entry is then
``-c(n - read_len)``; a cluster of 3 CTAs on 132 SMs) and 1,000 bases
(about 5M candidates a position). The card tests and ``chip_smoke.py --against``
hold the kernel to its twin on each.
"""

PACK_CASES = [(2_000_000, 5_000_000, 8, 128, 256, 128),
              (3_000_000, 2_000_000, 64, 128, 256, 512),
              (1_000, 10_000, 3, 64, 192, 32),
              (5_000, 8_192, 2, 64, 192, 128),
              (1_000, 1_000, 2, 64, 192, 128)]
