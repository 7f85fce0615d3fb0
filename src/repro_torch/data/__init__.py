"""Data of the port (counterpart of ``src/repro/data/``)."""
