"""Autocut: truncate a result list at the Nth score discontinuity.

Reference: ``entities/autocut/autocut.go`` — given scores sorted best-first,
divide the score range into per-result average steps; every gap larger than
the average step counts as a "jump"; keep results up to the Nth jump.
"""

from __future__ import annotations


def autocut(scores: list[float], n_jumps: int) -> int:
    """Return the cut index (exclusive) after the ``n_jumps``-th discontinuity.

    ``scores`` are sorted best-first (descending for similarities, ascending
    for distances — only the deltas matter). ``n_jumps <= 0`` disables.
    """
    if n_jumps <= 0 or len(scores) <= 1:
        return len(scores)
    total = abs(scores[-1] - scores[0])
    if total == 0:
        return len(scores)
    avg_step = total / len(scores)
    jumps = 0
    for i in range(1, len(scores)):
        gap = abs(scores[i] - scores[i - 1])
        if gap > avg_step:
            jumps += 1
            if jumps >= n_jumps:
                return i
    return len(scores)
