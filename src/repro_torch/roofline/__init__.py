"""Roofline terms for the dry-run: the analytic op inventory
(``analytic.py``, copied from the reference) and the summary of a lowered
step's logged collectives with the card's peaks (``analysis.py``).

Port of ``src/repro/roofline/``, which has no ``__init__.py``.
"""
