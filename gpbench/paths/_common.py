"""What both paths' sessions share: the benchmark's data and the program's
float32 product precision (the control switches on its TF32 path)."""

import torch

from stheno_torch import config as st_config

from ..harness import seeds

__all__ = ["uniform_sorted", "set_precision", "restore_precision"]


def uniform_sorted(config, seed, device):
    """``config["n"]`` sorted uniform points on ``[x_low, x_high]`` and a
    standard-normal vector of the same length, float32 on ``device``, from
    the run's data stream."""
    g = seeds.generator(device, seed, "data")
    n, lo, hi = config["n"], config["x_low"], config["x_high"]
    x = torch.sort(torch.rand(n, generator=g, device=device)).values * (hi - lo) + lo
    eps = torch.randn(n, generator=g, device=device)
    return x, eps


def set_precision(config, control):
    """Set the program's float32 product precision: the configuration's, or
    with ``control`` the program's own TF32 path (``"high"``). Returns the
    setting to restore."""
    prev = st_config.matmul_precision
    st_config.set_matmul_precision("high" if control else config["matmul_precision"])
    return prev


def restore_precision(prev):
    st_config.set_matmul_precision(prev)
