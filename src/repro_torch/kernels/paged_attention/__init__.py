"""B2 paged decode attend and the pool scatters (``ops``)."""
