"""Serving subsystem of the port (counterpart of ``src/repro/serve/``):
``packed_params`` (element-packed store), ``batcher`` (slot-paged KV +
continuous batching), ``cache_store`` (lane pool), ``engine`` (request
lifecycle) and ``fleet`` (one admission queue over N replicas, the
KV-affinity router, disaggregated prefill/decode, the asyncio
frontend)."""

from repro_torch.serve.fleet import (AsyncFrontend, FleetConfig,
                                     FleetRequest, Router, ServeFleet)

__all__ = ["AsyncFrontend", "FleetConfig", "FleetRequest", "Router",
           "ServeFleet"]
