"""Metrics registry used by the scheduler and the block pool."""
