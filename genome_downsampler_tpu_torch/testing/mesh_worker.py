"""One rank of a multi-process mesh job, and a launcher for N of them.

    GD_COORDINATOR=127.0.0.1:PORT GD_NUM_PROCESSES=N GD_PROCESS_ID=r \\
        python -m genome_downsampler_tpu_torch.testing.mesh_worker DIR

starts ``torch.distributed`` (``parallel.launch.initialize_distributed``),
reads the job from ``DIR/job.json`` (its name, device and parameters) and
its arrays from ``DIR/in.npz``, runs it on this rank and writes
``DIR/rank<r>.npz``. Jobs:

- ``solve_on_mesh``: ``parallel.mesh.solve_on_mesh`` (arrays ``start``,
  ``end``; parameters ``n``, ``m``, ``max_span``) -> ``sel`` and
  ``stats``, the solver's ``last_stats`` as JSON;
- ``blocked_mesh``: ``parallel.sharded_io.solve_blocked_on_mesh`` (also
  ``w_local``, ``block``) -> ``sel``, ``stats``;
- ``dryrun``: ``entry.dryrun_multichip`` -> its result;
- ``run_sharded``: ``parallel.sharded_io.run_sharded`` (its keyword
  arguments; rank 0 writes ``out_path``) -> ``merged``, ``stats`` and
  ``qmcp_stats`` (``LAST_QMCP_STATS``).

Each result also holds ``seconds``, the job's wall time on this rank.
``spawn_ranks`` runs N ranks on this host, each rendezvousing at a port
found by binding port 0, and kills them all if the time-out passes.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def _run_job(name: str, device: str, p: dict, arrays) -> dict:
    from genome_downsampler_tpu_torch.parallel.launch import global_window_mesh

    if name == "dryrun":
        from genome_downsampler_tpu_torch.entry import dryrun_multichip

        return dryrun_multichip(device)
    if name == "run_sharded":
        from genome_downsampler_tpu_torch.config import BamApiConfig
        from genome_downsampler_tpu_torch.parallel import sharded_io

        stats = {}
        merged = sharded_io.run_sharded(
            p.pop("path"), p.pop("m"), BamApiConfig(min_mapq=0, min_seq_length=0),
            p.pop("out_path", None), device=device, stats=stats, **p,
        )
        return {"merged": merged, "stats": json.dumps(stats),
                "qmcp_stats": json.dumps(sharded_io.LAST_QMCP_STATS)}
    mesh = global_window_mesh(device)
    stats = {}
    if name == "solve_on_mesh":
        from genome_downsampler_tpu_torch.parallel.mesh import solve_on_mesh

        sel = solve_on_mesh(mesh, arrays["start"], arrays["end"], p["n"], p["m"],
                            p["max_span"], stats=stats)
    elif name == "blocked_mesh":
        from genome_downsampler_tpu_torch.parallel.sharded_io import solve_blocked_on_mesh

        sel = solve_blocked_on_mesh(mesh, arrays["start"], arrays["end"], p["n"], p["m"],
                                    p["w_local"], p["block"], p["max_span"], stats=stats)
    else:
        raise ValueError(f"unknown job {name!r}")
    return {"sel": sel, "stats": json.dumps(stats)}


def main(argv=None) -> int:
    import torch.distributed as dist

    from genome_downsampler_tpu_torch.parallel.launch import initialize_distributed

    (workdir,) = argv if argv is not None else sys.argv[1:]
    workdir = Path(workdir)
    job = json.loads((workdir / "job.json").read_text())
    arrays = np.load(workdir / "in.npz") if (workdir / "in.npz").exists() else {}
    created = initialize_distributed(device=job["device"])
    try:
        t0 = time.perf_counter()
        out = _run_job(job["name"], job["device"], dict(job["params"]), arrays)
        out["seconds"] = time.perf_counter() - t0
        np.savez(workdir / f"rank{dist.get_rank()}.npz", **out)
    finally:
        if created:
            dist.destroy_process_group()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(name: str, n_ranks: int, workdir: Path | str, *, device: str = "cpu",
                params: dict | None = None, arrays: dict | None = None,
                timeout: float = 120.0):
    """Run job ``name`` on ``n_ranks`` processes of this host. Returns
    ``(returncodes, outputs, results)``: each rank's exit code, its
    stdout and stderr (``DIR/rank<r>.log``), and its result dict (None where
    it wrote none).
    Raises ``subprocess.TimeoutExpired`` after killing every rank if one
    outlives ``timeout`` seconds."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "job.json").write_text(
        json.dumps({"name": name, "device": device, "params": params or {}})
    )
    if arrays:
        np.savez(workdir / "in.npz", **arrays)
    env = dict(os.environ, GD_COORDINATOR=f"127.0.0.1:{free_port()}",
               GD_NUM_PROCESSES=str(n_ranks),
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    logs = [workdir / f"rank{r}.log" for r in range(n_ranks)]
    procs = []
    try:
        for r in range(n_ranks):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "genome_downsampler_tpu_torch.testing.mesh_worker", str(workdir)],
                    env=dict(env, GD_PROCESS_ID=str(r)), cwd=ROOT,
                    stdout=log, stderr=subprocess.STDOUT,
                ))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r in range(n_ranks):
        f = workdir / f"rank{r}.npz"
        results.append(dict(np.load(f)) if f.exists() else None)
    return ([p.returncode for p in procs], [f.read_text() for f in logs], results)


if __name__ == "__main__":
    sys.exit(main())
