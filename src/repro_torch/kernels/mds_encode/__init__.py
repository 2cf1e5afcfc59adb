"""B3 MDS encode (``ops.mds_encode``)."""
