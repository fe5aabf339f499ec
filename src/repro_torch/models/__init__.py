"""Decoder model blocks, cached decoding and model-level helpers."""
