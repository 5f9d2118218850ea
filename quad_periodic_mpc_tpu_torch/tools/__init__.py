"""The repo's evidence tools on the port (counterparts of the JAX package's
``tools/parity_table.py`` and ``tools/estimator_ab.py``):

    python -m quad_periodic_mpc_tpu_torch.tools.parity_table [--cpu] [--update]
    python -m quad_periodic_mpc_tpu_torch.tools.estimator_ab [--cpu] [--update] ...

Each runs on the CUDA card unless given ``--cpu`` (the kernels' plain
versions) and refuses to run without a card otherwise.  ``--update``
rewrites the tool's block between its markers in the repo's PERF.md;
without it the tool prints its table."""

from __future__ import annotations

import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PERF_MD = os.path.join(REPO, "PERF.md")


def pick_device(cpu: bool) -> torch.device:
    """The CPU when asked for, else CUDA card 0; without a card, exit
    non-zero rather than run on the CPU."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool runs on a GPU unless given --cpu")
    return torch.device("cuda", 0)


def device_line(device: torch.device) -> str:
    """What ran the solves: the card's name and power limit as nvidia-smi
    gives them, or the CPU."""
    if device.type != "cuda":
        return "the CPU (the kernels' plain versions)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def write_block(begin: str, end: str, text: str, path: str | None = None) -> None:
    """Replace what lies between the ``begin`` and ``end`` markers of
    ``path`` (default: PERF_MD) with ``text``."""
    path = path or PERF_MD
    with open(path) as f:
        doc = f.read()
    if begin not in doc or end not in doc:
        raise SystemExit(f"{path} has no {begin} ... {end} block")
    doc = doc.split(begin)[0] + begin + "\n" + text + "\n" + end + doc.split(end, 1)[1]
    with open(path, "w") as f:
        f.write(doc)
    print(f"updated {path}", file=sys.stderr)
