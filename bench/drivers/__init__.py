"""Drivers: one module a kind of cell (``drivers/<driver>.py``), named by
the cell's ``driver`` key."""
