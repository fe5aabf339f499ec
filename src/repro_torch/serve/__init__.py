"""Continuous-batching serving engine."""
