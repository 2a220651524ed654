"""Model zoo of the port: dense and SSM (Mamba2) decoder LMs
(``transformer.DecoderLM``) and their attention, Mamba2, MLP and common
blocks.  MoE, hybrid, enc-dec, the CNN and sharding are still to port
(ROADMAP queue 1, items 10 and 17)."""
from repro_torch.models.transformer import DecoderLM

__all__ = ["DecoderLM"]
