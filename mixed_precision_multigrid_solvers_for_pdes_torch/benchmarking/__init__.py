"""Measurement tools that run on the CUDA card (none falls back to the CPU)."""
