"""N:M sparsity core of the port (counterpart of ``src/repro/core/``)."""
