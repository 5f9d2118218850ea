"""What the seed draws: the traffic's free values, on the device, in
float64, from one ``torch.Generator`` per run.  The seed never changes a
shape or a count."""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def uniform(g: torch.Generator, n: int, lo: float, hi: float, device) -> torch.Tensor:
    """(n,) float64 in [lo, hi)."""
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)


def integers(g: torch.Generator, n: int, hi: int, device) -> torch.Tensor:
    """(n,) int64 in [0, hi)."""
    return torch.randint(0, hi, (n,), generator=g, device=device)


def window_samples(g: torch.Generator, count: int, device) -> list[float]:
    """``count`` fractions of the window at which a unit is kept for the
    comparison: one drawn in each of ``count`` equal spans of [0.1, 0.95)."""
    u = torch.rand(count, generator=g, device=device, dtype=torch.float64).tolist()
    span = 0.85 / count
    return [0.1 + span * (i + x) for i, x in enumerate(u)]
