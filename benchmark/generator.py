"""The one traffic generator: a traffic file's template draws, made from
the seed, in requests.

A traffic file (traffic/<name>.json) holds

    "draws": {template: count, ...}   how many queries each of the
                                      schema's templates contributes
    "draws_per_request": k            draws a request (a batch ended by
                                      F in the contest protocol)

Every seed gets the same draws in another order: the draws come in
rounds, one of each template that still has draws left, each round in a
seed-shuffled order, so any stretch of the cycle holds the templates in
their shares. A draw's parameters come from the seed too.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

TRAFFIC_STREAM = 1          # the seed's numpy stream for queries


def requests(traffic: dict, templates: Dict[str, object], seed: int
             ) -> List[Tuple[str, List[str], int]]:
    """[(label, query lines, draws)] of one cycle; a label names the
    request's templates. A draw is one query as its user wrote it, which
    a template may send as several lines (SSB's Q3.3: four sub-queries
    whose sums add)."""
    rng = np.random.default_rng([int(seed), TRAFFIC_STREAM])
    left = dict(traffic["draws"])
    order: List[str] = []
    while any(left.values()):
        names = [n for n in left if left[n] > 0]
        for i in rng.permutation(len(names)):
            order.append(names[i])
            left[names[i]] -= 1
    draws = [(name, templates[name](rng)) for name in order]
    k = int(traffic["draws_per_request"])
    out = []
    for i in range(0, len(draws), k):
        group = draws[i:i + k]
        out.append(("+".join(sorted({n for n, _ in group})),
                    [ln for _, lines in group for ln in lines], len(group)))
    return out
