"""Planning math, MDS coding and the coded-computation engine."""
