"""Serving subsystem of the port (counterpart of ``src/repro/serve/``):
``packed_params`` (element-packed store), ``batcher`` (slot-paged KV +
continuous batching), ``cache_store`` (lane pool) and ``engine``
(request lifecycle).  The fleet is not ported yet."""
