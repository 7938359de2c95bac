"""The benchmark's fixed arithmetic: the card's published peaks, the least
time a piece of work could take on it, and the card's name and power
limit that every number is printed beside."""

from __future__ import annotations

import subprocess

# NVIDIA H100 SXM, published at 700 W: HBM3 bytes/s and float32
# operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card could take: the larger of the bytes over
    HBM's rate and the float32 operations over the peak."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S)


def card_line(index: int = 0) -> str:
    """'<name>, <power limit>' of a card, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.strip().splitlines()[0].strip() if out.strip() else "nvidia-smi gave nothing"
