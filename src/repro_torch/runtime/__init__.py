"""Fault-tolerant training loop."""
