"""The numbers that decide ``correct``, and their limits.

Each cell's limits are in ``limits/<workload>.json``: for every number
compared, the limit and the readings it was set from.  A number passes
when it is finite and at most its limit; a number with no limit fails.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

LIMITS_DIR = Path(__file__).resolve().parent / "limits"


def relative_gap(value: float, ref: float) -> float:
    return abs(value - ref) / max(abs(ref), 1e-30)


def worst_leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    """The largest gap of a leaf's norm, |prog - ref|, over the larger of
    the reference's norm of that leaf and of the median leaf."""
    names = sorted(ref) if leaves is None else list(leaves)
    median = statistics.median(ref[n] for n in sorted(ref))
    return max(abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names)


def moving_leaves(ref_grad: dict) -> list[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: below that, Adam moves a leaf by round-off alone."""
    median = statistics.median(ref_grad.values())
    return [n for n in sorted(ref_grad) if ref_grad[n] >= 1e-3 * median]


def load_limits(workload: str, root: Path = LIMITS_DIR) -> dict:
    path = root / f"{workload}.json"
    if not path.exists():
        return {}
    return {k: v["limit"] for k, v in json.loads(path.read_text()).items()}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers compared."""
    out, correct = {}, True
    for name in sorted(numbers):
        value, limit = numbers[name], limits.get(name)
        ok = (limit is not None and value is not None and math.isfinite(value)
              and value <= limit)
        correct = correct and ok
        out[name] = {"value": value, "limit": limit}
    return correct, out
