"""Model zoo of the port: the paper's CNNs (``cnn``), dense and SSM (Mamba2)
decoder LMs (``transformer.DecoderLM``) and their attention, Mamba2, MLP and
common blocks.  MoE, hybrid, enc-dec and sharding are still to port (ROADMAP
queue 1, item 17)."""
from repro_torch.models.cnn import CNNModel, accuracy_fn, make_cnn, masked_xent_loss
from repro_torch.models.transformer import DecoderLM

__all__ = ["CNNModel", "make_cnn", "masked_xent_loss", "accuracy_fn", "DecoderLM"]
