"""Serving steps of a decoder LM or an encoder-decoder (counterpart of
repro/launch/serve.py).

Batched requests share a uniform position counter, as in the JAX package.
The model is a ``repro_torch.models.DecoderLM``: dense, MoE or VLM (a KV
cache per layer), Mamba2 (a conv window and an SSM state per layer, in
float32) or hybrid (both: one per Mamba2 layer, a KV cache per site of the
shared block); or, with ``is_encdec=True``, an ``EncDecLM`` (whisper: a KV
cache per decoder layer, the encoder's output carried beside the caches).
Weights, caches and tokens live on the model's device (the card unless the
model was built for the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.encdec import EncDecLM

__all__ = ["ServeEngine"]


@dataclasses.dataclass
class ServeEngine:
    model: Any                 # DecoderLM | EncDecLM
    is_encdec: bool = False

    def make_decode_step(self):
        """``decode_step(token, pos, caches) -> (next_token, logits, caches)``;
        with ``is_encdec``, ``decode_step(token, pos, caches, enc_out)``."""
        model = self.model

        if self.is_encdec:
            def decode_step(token, pos, caches, enc_out):
                logits, caches = model.decode_step(token, pos, enc_out, caches)
                return logits.argmax(dim=-1), logits, caches
        else:
            def decode_step(token, pos, caches):
                logits, caches = model.decode_step(token, pos, caches)
                return logits.argmax(dim=-1), logits, caches

        return decode_step

    def make_prefill_step(self):
        """``prefill_step(tokens, caches) -> (next_token, caches)``; with
        ``is_encdec``, ``prefill_step(frames, tokens, caches) -> (next_token,
        caches, enc_out)``: the encoder on ``frames``, then the decoder's
        prefill of ``tokens``."""
        model = self.model

        if self.is_encdec:
            def prefill_step(frames, tokens, caches):
                enc_out = model.encode(frames)
                logits, caches = model.decode(tokens, enc_out, caches=caches)
                return logits[:, -1].argmax(dim=-1), caches, enc_out
        else:
            def prefill_step(tokens, caches):
                logits, caches = model.prefill(tokens, caches)
                return logits.argmax(dim=-1), caches

        return prefill_step

    @torch.inference_mode()
    def generate(self, prompt_tokens: torch.Tensor, max_new: int, cache_len: int) -> torch.Tensor:
        """Greedy generation: (B, max_new) token ids, the first from the
        prefill.  A decoder LM only, as in the JAX package."""
        if isinstance(self.model, EncDecLM):
            raise NotImplementedError(
                "generate serves a decoder LM; an encoder-decoder is served through "
                "make_prefill_step() (frames, tokens, caches -> next token, caches, enc_out) "
                "and make_decode_step() (token, pos, caches, enc_out), as the JAX package's "
                "generate cannot serve its EncDecLM either")
        model = self.model
        prompt_tokens = prompt_tokens.to(model.device)
        b, s = prompt_tokens.shape
        caches = model.init_cache(b, cache_len)
        tok, caches = self.make_prefill_step()(prompt_tokens, caches)
        decode = self.make_decode_step()
        out = [tok]
        for pos in range(s, s + max_new - 1):
            tok, _, caches = decode(tok, pos, caches)
            out.append(tok)
        return torch.stack(out, dim=1)
