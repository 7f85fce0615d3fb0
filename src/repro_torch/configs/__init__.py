"""Model configs of the port (own copies of ``src/repro/configs/``; only
qwen3-8b, the slice's model, so far)."""
