"""Serving steps of a decoder LM (counterpart of repro/launch/serve.py).

Batched requests share a uniform position counter, as in the JAX package.
The model is a ``repro_torch.models.DecoderLM``, dense (a KV cache per layer)
or Mamba2 (a conv window and an SSM state per layer, in float32); its
weights, caches and tokens live on the model's device (the card unless the
model was built for the CPU).  Encoder-decoder serving is still to port
(ROADMAP queue 1, item 17).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import DecoderLM

__all__ = ["ServeEngine"]


@dataclasses.dataclass
class ServeEngine:
    model: DecoderLM

    def make_decode_step(self):
        """``decode_step(token, pos, caches) -> (next_token, logits, caches)``."""
        model = self.model

        def decode_step(token, pos, caches):
            logits, caches = model.decode_step(token, pos, caches)
            return logits.argmax(dim=-1), logits, caches

        return decode_step

    def make_prefill_step(self):
        """``prefill_step(tokens, caches) -> (next_token, caches)``."""
        model = self.model

        def prefill_step(tokens, caches):
            logits, caches = model.prefill(tokens, caches)
            return logits.argmax(dim=-1), caches

        return prefill_step

    @torch.inference_mode()
    def generate(self, prompt_tokens: torch.Tensor, max_new: int, cache_len: int) -> torch.Tensor:
        """Greedy generation: (B, max_new) token ids, the first from the prefill."""
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
