"""Filter opcodes (counterpart: radixhashjoin_tpu/ops/filter.py).

Only the constants the planner and DeviceCatalog.encode_filter use: on
the factorized path a filter is a boolean mask built inside the wave
(ops/factorized.py), never a compacted rowid set.
"""

OP_EQ, OP_LT, OP_GT = 0, 1, 2
OP_CODE = {"=": OP_EQ, "<": OP_LT, ">": OP_GT}
