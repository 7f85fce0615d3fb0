"""Steps and loop of the port (counterpart of ``src/repro/train/``)."""
