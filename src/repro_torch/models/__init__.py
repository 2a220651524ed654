"""Model zoo of the port: the paper's CNNs (``cnn``), dense, MoE, SSM
(Mamba2), hybrid and VLM decoder LMs (``transformer.DecoderLM``) and their
attention, MoE, Mamba2, MLP and common blocks.  Enc-dec (``encdec.py``) is
still to port (ROADMAP queue 1, item 17), sharding with item 16."""
from repro_torch.models.cnn import CNNModel, accuracy_fn, make_cnn, masked_xent_loss
from repro_torch.models.transformer import DecoderLM

__all__ = ["CNNModel", "make_cnn", "masked_xent_loss", "accuracy_fn", "DecoderLM"]
