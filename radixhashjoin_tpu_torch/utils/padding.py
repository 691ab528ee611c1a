"""Shape-bucket padding policy
(counterpart: radixhashjoin_tpu/utils/padding.py).

Eager PyTorch needs no static shapes; the bucket survives only as the
catalog's `bucket` helper so sizes stay comparable with the reference.
"""

from __future__ import annotations


def bucket_size(n: int, min_pad: int = 1024, base: int = 2) -> int:
    """Smallest min_pad * base**k >= max(n, 1)."""
    size = min_pad
    n = max(int(n), 1)
    while size < n:
        size *= base
    return size
