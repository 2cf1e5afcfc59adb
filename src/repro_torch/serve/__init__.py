"""Continuous-batching front-end: request workloads and the slot scheduler."""
