"""Probes: kernels that measure the card (port of ``docs/probes/``)."""
