"""The card a run measures on: the check that it is there, and what the
result line says of it."""

import subprocess

import torch

__all__ = ["NoCard", "require", "describe", "power_limit"]


class NoCard(RuntimeError):
    """No CUDA card, or fewer than the cell asks for: no result."""


def require(chips):
    """Raise :class:`NoCard` unless ``chips`` CUDA cards are present."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def describe(device, chips, memory_peak_bytes):
    """The result line's ``device`` object."""
    dev = torch.device(device)
    if dev.type == "cuda":
        platform, kind = "gpu", torch.cuda.get_device_name(dev)
    else:
        platform, kind = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": chips,
            "memory_peak_bytes": int(memory_peak_bytes)}


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"
