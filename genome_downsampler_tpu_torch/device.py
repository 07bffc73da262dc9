"""CUDA device probe.

Counterpart of ``tpu_available`` in the JAX package's ``ops/pallas_sweep.py``,
with one difference: the port never picks a backend on its own. A caller
names ``"cuda"`` or ``"cpu"``; asking for CUDA on a machine without a card
raises instead of quietly running the CPU path.
"""

from __future__ import annotations

import shutil
import subprocess

import torch


def require_cuda() -> torch.device:
    """``torch.device("cuda")``, or a RuntimeError naming why it is absent."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available (torch "
            f"{torch.__version__}, built for CUDA {torch.version.cuda}); the "
            "*-cuda solvers need an NVIDIA GPU and do not fall back to the CPU"
        )
    return torch.device("cuda")


def resolve_device(device: str | torch.device) -> torch.device:
    """Validate an explicit device name: ``cuda`` (checked) or ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")


def gpu_report() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (one line per card)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
