"""Model zoo of the port: the paper's CNNs (``cnn``), dense, MoE, SSM
(Mamba2), hybrid and VLM decoder LMs (``transformer.DecoderLM``), whisper's
encoder-decoder (``encdec.EncDecLM``) and their attention, MoE, Mamba2, MLP
and common blocks, and the logical-axis rules (``sharding``) that place a
federated cohort's client axis on a client mesh."""
from repro_torch.models.cnn import CNNModel, accuracy_fn, make_cnn, masked_xent_loss
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM


def build_model(cfg, **kwargs):
    """Factory: ModelConfig -> DecoderLM or EncDecLM (``audio``)."""
    if cfg.arch_type == "audio":
        return EncDecLM(cfg, **kwargs)
    return DecoderLM(cfg, **kwargs)


__all__ = ["CNNModel", "make_cnn", "masked_xent_loss", "accuracy_fn", "DecoderLM", "EncDecLM",
           "build_model"]
