"""Device resolution for the port's entry points (no reference counterpart).

The reference lets JAX pick its default backend.  The port's entry
points (``models.transformer_lm.init``, ``serve.packed_params.
pack_tree_element``, ``serve.engine.ServeEngine``, ``convert``) run on
the card unless the caller names another device; they never fall back
to the CPU on their own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises when ``device`` is ``None`` and no card is present: running
    on the CPU is something the caller asks for (``device="cpu"``), as
    the CPU tests do.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port's plain "
                "PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
