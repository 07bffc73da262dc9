"""Sharded exact QMCP at config-4's size: 2 ranks over gloo on the host.

    python -m genome_downsampler_tpu_torch.scripts.bench_sharded_qmcp [reads_M]

Counterpart of the JAX package's ``scripts/bench_sharded_qmcp.py``: a
config-4 BAM (10M reads of 150 bp over 5 Mb from seed 12345, MAPQ 20-69,
written once by the port's fast writer with its index and cached under
``build/bench_cache/``) through ``parallel.sharded_io.run_sharded(...,
algorithm="qmcp-cpu", halo=4096, max_span=256)`` at M = 50 on two ranks,
started by ``testing.mesh_worker.spawn_ranks``: the partitioned bucket
gather and the replicated bucket MCMF on the host. Prints each rank's
seconds and ``LAST_QMCP_STATS`` (buckets, pool units, gathered MB and its
share of replicating every read's tuple) and a JSON line of the numbers.
Checks: both ranks exit 0 with the same merged selection, and the output
BAM (rank 0's) covers ``min(coverage, M)`` at every base of the input.
Exits non-zero if a check fails. It runs on the card's machine and needs
a card (raises without one); the ranks' tensors live on ``device``, which
puts two ranks of one card on gloo.

One departure from the JAX script's reads: there each read's mate starts
anywhere on the genome, farther than any halo, which the JAX package's
fast writer hid by naming no mate. The port's writer names each mate, and
``run_sharded`` rightly refuses a halo of 4,096 over such pairs. So here
mates start at most ``MAX_INSERT - 150`` bases apart, as in a real
library (``chip_smoke.py``'s sharded cells do the same).
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from genome_downsampler_tpu_torch.config import BamApiConfig
from genome_downsampler_tpu_torch.device import resolve_device
from genome_downsampler_tpu_torch.io.bam import read_bam
from genome_downsampler_tpu_torch.scripts import probe_main, read_batch
from genome_downsampler_tpu_torch.testing.bam_writer import write_indexed_test_bam_fast
from genome_downsampler_tpu_torch.testing.coverage_tester import _coverage, is_out_cover_valid
from genome_downsampler_tpu_torch.testing.mesh_worker import ROOT, spawn_ranks

READS = 10_000_000
GENOME, M = 5_000_000, 50
HALO, MAX_SPAN = 4096, 256
MAX_INSERT = 600
RANKS = 2
CACHE = ROOT / "build" / "bench_cache"
SEED = 12345


def config4_bam(reads: int, genome: int, cache: Path, log=print) -> Path:
    """The cached BAM of ``reads`` reads (``reads // 2`` pairs) over
    ``genome`` bases, written (with its ``.bai``) if absent."""
    bam = Path(cache) / f"config4_insert{MAX_INSERT}_{reads}_{genome}.bam"
    if bam.exists() and Path(str(bam) + ".bai").exists():
        return bam
    bam.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    pairs = reads // 2
    first = rng.integers(0, genome - MAX_INSERT, pairs)
    starts = np.empty(2 * pairs, np.int64)
    starts[0::2] = first
    starts[1::2] = first + rng.integers(0, MAX_INSERT - 150 + 1, pairs)
    batch = read_batch(starts, starts + 149, genome,
                       quality=rng.integers(20, 70, 2 * pairs).astype(np.int32))
    t0 = time.perf_counter()
    tmp = bam.with_name(bam.name + ".tmp")
    write_indexed_test_bam_fast(tmp, batch)
    Path(str(tmp) + ".bai").replace(str(bam) + ".bai")
    tmp.replace(bam)
    log(f"synth {bam}: {time.perf_counter() - t0:.1f}s")
    return bam


def run(device, reads: int = READS, *, genome: int = GENOME, cache: Path = CACHE,
        out_path: Path | None = None, timeout: float = 1100.0, log=print) -> dict:
    """The sharded QMCP run on ``RANKS`` ranks (each on ``device``); rank 0
    writes ``out_path`` (a temporary file unless given). Returns each
    rank's seconds and QMCP stats, the total wall time, the merged count,
    the checks and ``ok``."""
    dev = resolve_device(device)
    bam = config4_bam(reads, genome, cache, log)
    cfg = BamApiConfig(min_mapq=0, min_seq_length=0)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(out_path or Path(tmp) / "out.bam")
        t0 = time.perf_counter()
        rcs, logs, res = spawn_ranks(
            "run_sharded", RANKS, Path(tmp) / "ranks", device=str(dev), timeout=timeout,
            params={"path": str(bam), "m": M, "out_path": str(out), "halo": HALO,
                    "max_span": MAX_SPAN, "algorithm": "qmcp-cpu"})
        wall = time.perf_counter() - t0
        ranks = []
        for r, (rc, text, got) in enumerate(zip(rcs, logs, res)):
            log(f"--- rank {r} (rc={rc})")
            if rc != 0 or got is None:
                log(text[-3000:])
                ranks.append({"rc": rc})
                continue
            st = json.loads(str(got["qmcp_stats"]))
            frac = st["gathered_bytes"] / max(st["replicated_tuple_bytes_r3"], 1)
            ranks.append({"rc": rc, "seconds": float(got["seconds"]),
                          "merged": int(got["merged"].shape[0]), "qmcp_stats": st,
                          "gathered_frac": frac})
            log(f"rank {r}: {ranks[-1]['seconds']:.1f}s merged={ranks[-1]['merged']} "
                f"buckets={st['buckets']} pool_units={st['pool_units']} "
                f"gathered={st['gathered_bytes'] / 1e6:.1f}MB (replicated scheme "
                f"{st['replicated_tuple_bytes_r3'] / 1e6:.1f}MB, frac={frac:.3f})")
        ran = all(rc == 0 for rc in rcs) and all(r is not None for r in res)
        same = ran and all(np.array_equal(r["merged"], res[0]["merged"]) for r in res)
        valid = False
        if ran:
            t1 = time.perf_counter()
            got, _, _ = read_bam(out, cfg)
            full, _, _ = read_bam(bam, cfg)
            valid = is_out_cover_valid(_coverage(full), _coverage(got), M)
            log(f"output BAM {got.n_reads} records, coverage valid {valid} "
                f"({time.perf_counter() - t1:.1f}s to check)")
    log(f"total wall: {wall:.1f}s; ranks' merged selections equal {same}")
    return {"reads": reads, "genome": genome, "M": M, "halo": HALO, "max_span": MAX_SPAN,
            "ranks": ranks, "device": str(dev), "wall_s": wall, "merged_equal": same,
            "valid": valid, "ok": bool(same and valid)}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    probe_main(run, int(float(argv[0]) * 1e6) if argv else READS)


if __name__ == "__main__":
    main()
