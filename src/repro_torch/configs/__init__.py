"""Model configs of the port (own copies of ``src/repro/configs/``:
qwen3-8b and the paper's Table I models so far)."""
