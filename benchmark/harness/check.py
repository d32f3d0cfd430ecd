"""The comparison that decides ``correct``: the numbers a cell's family
reads from the window's outputs against a plain reference (``readings``,
``benchmark/families/<family>.py``), each held to its limit in the
configuration's ``limits``, and no item failed.
"""
from __future__ import annotations

from typing import Dict, Tuple


def bucket(n: int, size: int) -> int:
    return max(size, -(-n // size) * size)


def judge(numbers: Dict[str, float], failed: int,
          limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """``correct``, and each number beside its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and all(v <= limits[k] for k, v in numbers.items())
    return correct, checks
