"""Models of the port (counterpart of ``src/repro/models/``: the dense GQA
decoder LM and the paper's convnets and ViT so far)."""
