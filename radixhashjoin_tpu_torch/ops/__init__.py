"""Device operators: the factorized wave, the fused stage runner, and the
message-table build/lookup primitives."""
