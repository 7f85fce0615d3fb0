"""Models of the port (counterpart of ``src/repro/models/``: the decoder
LM families, the encoder-decoder, and the paper's convnets and ViT)."""
