"""Measurement tools of the port: ``probe_vpu``, the card's integer-instruction
and device-memory ceilings."""
