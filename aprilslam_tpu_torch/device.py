"""Device selection for the port's entry points."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA device. Raises when CUDA is asked for and absent:
    the entry points never fall back to the CPU on their own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them.
    Raises when nvidia-smi fails."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]
