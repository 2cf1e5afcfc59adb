"""Coded round executor and the paged serving loop."""
