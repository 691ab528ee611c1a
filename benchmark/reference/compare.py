"""The comparison that decides `correct`: every line the window printed
against the reference's line for the same query. The answers are exact
uint64 SUMs (or NULL), so a line is right only when it is equal, and
each number compared has the limit 0.

    mismatched_lines  lines that differ from the reference's
    missing_lines     lines of requests that raised or returned another
                      number of lines than they had queries
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

LIMITS = {"mismatched_lines": 0, "missing_lines": 0}


def compare(pairs: Sequence[Tuple[List[str], Optional[List[str]]]]):
    """(checks, correct, failed requests) over [(reference lines, program
    lines or None)], one pair a request."""
    mismatched = missing = failed = 0
    for want, got in pairs:
        if got is None or len(got) != len(want):
            missing += len(want)
            failed += 1
            continue
        wrong = sum(a != b for a, b in zip(want, got))
        mismatched += wrong
        failed += wrong > 0
    values = {"mismatched_lines": mismatched, "missing_lines": missing}
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}
    correct = all(v <= LIMITS[k] for k, v in values.items())
    return checks, correct, failed
