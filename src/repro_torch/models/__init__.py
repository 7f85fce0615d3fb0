"""Models of the port (counterpart of ``src/repro/models/``; the dense GQA
decoder LM so far)."""
