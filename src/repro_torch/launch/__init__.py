"""Launchers (ports of ``src/repro/launch/``)."""
