"""B1 coded matvec (``ops.blocked_matvec``)."""
