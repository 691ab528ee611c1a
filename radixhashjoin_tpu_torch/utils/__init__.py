"""Utilities: padding policy, exact int64 SUM folds, primes, per-operator
roofline profiling."""

from .primes import is_prime, next_pow2, next_prime, pow2
from .profiling import OpProfiler, arr_bytes

__all__ = ["is_prime", "next_prime", "next_pow2", "pow2", "OpProfiler",
           "arr_bytes"]
