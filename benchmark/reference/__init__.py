"""The plain references (semantics.py, shared; a configuration may name
its own) and the comparison that decides `correct`."""
