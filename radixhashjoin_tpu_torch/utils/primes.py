"""Math utils (counterpart: radixhashjoin_tpu/utils/primes.py; reference
parity: auxFun.cpp:4-26 of the C++ engine).

The reference sizes its chained hash tables with `next_prime(|build|)`
(Result.cpp:45). The port's direct-address and sort joins need no
prime-sized tables; the helpers stay part of the public surface for
users sizing their own hash structures, as in the JAX package.
"""

from __future__ import annotations


def is_prime(n: int) -> bool:
    """6k±1 trial division."""
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0 or n % 3 == 0:
        return False
    i = 5
    while i * i <= n:
        if n % i == 0 or n % (i + 2) == 0:
            return False
        i += 6
    return True


def next_prime(n: int) -> int:
    """Smallest prime >= n (reference: auxFun.cpp:4-22)."""
    n = max(int(n), 2)
    while not is_prime(n):
        n += 1
    return n


def pow2(k: int) -> int:
    """2**k (reference: auxFun.cpp:24-26)."""
    return 1 << k


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    p = 1
    n = max(int(n), 1)
    while p < n:
        p <<= 1
    return p
