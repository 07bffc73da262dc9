"""The host BAM engine's throughput: read and write at 1, 4 and 8 threads.

    python -m genome_downsampler_tpu_torch.scripts.bench_io [pairs_millions]

Counterpart of the JAX package's ``scripts/bench_io.py``: 1M pairs of 150
bp over 30 kb from seed 12345, written as a BAM by the port's fast writer
(``testing.bam_writer.write_test_bam_fast``, untimed), then the port's
``io.bam.read_bam`` (BGZF inflate, record parse, pairing by QNAME) and
``write_bam`` (re-stream of every other record) timed at each thread
count, in records and MB a second. Checks: every read comes back, with the
synthesized reads' starts and ends, the same batch at every thread count,
and the same output bytes at every thread count. Prints the laps and a
JSON line of the numbers; exits non-zero if a check fails. The BAM engine
is host code; the probe runs on the card's machine, so it needs a card
and raises without one.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from genome_downsampler_tpu_torch.config import BamApiConfig
from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.io.bam import read_bam, write_bam
from genome_downsampler_tpu_torch.scripts import probe_main
from genome_downsampler_tpu_torch.testing.bam_writer import write_test_bam_fast
from genome_downsampler_tpu_torch.testing.reads_gen import rand_reads_uniform

PAIRS = 1_000_000
GENOME = 30_000
THREADS = (1, 4, 8)
SEED = 12345


def _same_batch(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("bam_id", "start", "end", "quality", "is_first"))


def run(device, pairs: int = PAIRS, *, workdir=None, log=print) -> dict:
    """Synthesize ``pairs`` pairs into ``workdir/in.bam`` (a temporary
    directory unless given) and time the reader and writer at each thread
    count. Returns the record count, the BAM's MB, per thread count the
    read's and the write's seconds and rates, the checks and ``ok``."""
    dev = resolve_device(device)
    batch = rand_reads_uniform(np.random.default_rng(SEED), pairs, GENOME, 150)
    with tempfile.TemporaryDirectory() as tmp:
        wd = Path(workdir or tmp)
        path = wd / "in.bam"
        t0 = time.perf_counter()
        write_test_bam_fast(path, batch)
        synth_s = time.perf_counter() - t0
        size_mb = path.stat().st_size / 1e6
        log(f"synth {batch.n_reads} records -> {size_mb:.1f} MB ({synth_s:.1f} s, untimed)")

        reads, first = {}, None
        reads_equal = True
        for t in THREADS:
            cfg = BamApiConfig(min_mapq=0, min_seq_length=0, hts_thread_count=t)
            t0 = time.perf_counter()
            b, _, _ = read_bam(path, cfg)
            dt = time.perf_counter() - t0
            reads[str(t)] = {"s": dt, "records_per_s": b.n_reads / dt, "mb_per_s": size_mb / dt}
            log(f"read  -@{t}: {dt:.3f} s  {b.n_reads / dt / 1e6:.2f}M rec/s "
                f"{size_mb / dt:.0f} MB/s")
            if first is None:
                first = b
                order = np.argsort(b.bam_id, kind="stable")
                reads_equal = (b.n_reads == batch.n_reads and np.array_equal(
                    np.sort(b.start), np.sort(batch.start)) and np.array_equal(
                    np.sort(b.end), np.sort(batch.end)) and np.array_equal(
                    b.bam_id[order], np.arange(b.n_reads)))
            else:
                reads_equal = reads_equal and _same_batch(b, first)

        sel = np.arange(0, batch.n_reads, 2, dtype=np.int64)  # half the records
        writes, out_bytes = {}, None
        writes_equal = True
        for t in THREADS:
            out = wd / f"out{t}.bam"
            t0 = time.perf_counter()
            wrote = write_bam(path, out, sel, threads=t)
            dt = time.perf_counter() - t0
            writes[str(t)] = {"s": dt, "records_per_s": wrote / dt}
            log(f"write -@{t}: {dt:.3f} s  {wrote / dt / 1e6:.2f}M rec/s")
            data = out.read_bytes()
            out_bytes = out_bytes or data
            writes_equal = writes_equal and wrote == len(sel) and data == out_bytes
    log(f"reads equal to the synthesized ones at every thread count: {reads_equal}; "
        f"output bytes equal at every thread count: {writes_equal}")
    return {
        "pairs": pairs, "records": batch.n_reads, "genome": GENOME, "bam_mb": size_mb,
        "device": str(dev), "synth_s": synth_s, "read": reads, "write": writes,
        "written": len(sel), "reads_equal": bool(reads_equal),
        "writes_equal": bool(writes_equal), "ok": bool(reads_equal and writes_equal),
    }


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    probe_main(run, int(float(argv[0]) * 1e6) if argv else PAIRS)


if __name__ == "__main__":
    main()
