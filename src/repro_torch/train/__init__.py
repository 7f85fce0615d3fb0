"""Steps of the port (counterpart of ``src/repro/train/``; the serving
steps so far)."""
