"""Utilities: padding policy and exact int64 SUM folds."""
