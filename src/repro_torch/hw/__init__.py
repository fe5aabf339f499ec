"""Analytic hardware models."""
