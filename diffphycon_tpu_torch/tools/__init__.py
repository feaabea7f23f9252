"""Measurement tools of the port, run on an NVIDIA GPU (each module's
docstring says how)."""
