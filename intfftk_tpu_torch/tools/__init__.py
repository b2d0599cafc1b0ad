"""Measurement tools of the port: ``probe_vpu`` (the card's
integer-instruction and device-memory ceilings), ``probe_stages`` (what one
stage of the factor pass costs) and ``audit_sass`` (the instructions the
card was given to run, counted from the built library)."""
