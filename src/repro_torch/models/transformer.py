"""Decoder-only LM of the model zoo, dense and SSM (Mamba2) stacks
(counterpart of repro/models/transformer.py).

The JAX package stacks the blocks on a leading L axis and scans them; here
each block is an ``nn.ParameterDict`` with the JAX package's parameter names,
and the layers run in a plain Python loop.  MoE, hybrid, VLM and audio stacks
are still to port (ROADMAP queue 1, item 17), as is training through the model
(the flash and SSD kernels have no backward).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import Param, init_params, rms_norm, sinusoidal_positions

__all__ = ["DecoderLM"]

ARCHS = ("dense", "ssm")


def _block_defs(cfg: ModelConfig) -> dict[str, Param]:
    """Parameter defs for ONE block."""
    if cfg.arch_type == "ssm":
        return {"ln1": Param((cfg.d_model,), (None,)), **ssm_mod.ssm_defs(cfg)}
    return {
        "ln1": Param((cfg.d_model,), (None,)),
        "ln2": Param((cfg.d_model,), (None,)),
        **attn_mod.attention_defs(cfg),
        **mlp_mod.mlp_defs(cfg),
    }


class DecoderLM(nn.Module):
    """A dense or SSM (Mamba2) decoder LM.

    ``generator`` (a ``torch.Generator`` on ``device``) draws the initial
    weights as the JAX package's ``DecoderLM.init`` does (the same
    distributions, not the same values); with ``generator=None`` they are left
    uninitialised, to be filled by ``repro_torch.convert.decoder_from_jax``.
    ``attn_impl`` is ``"kernel"`` (the CUDA kernels on the card: flash
    attention in a dense stack, the SSD scan in an SSM stack; the JAX
    package's ``"pallas"``) or ``"dense"`` (the plain paths: dense attention,
    and the chunked SSD ``ssd_chunked``).  The model runs on the card unless
    ``device`` says otherwise.
    """

    max_positions = 32_768   # sinusoidal table rows (non-RoPE archs), as in the JAX package

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, attn_impl: str = "kernel",
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        if cfg.arch_type not in ARCHS:
            raise NotImplementedError(
                f"{cfg.name}: the port's DecoderLM runs {' and '.join(ARCHS)} stacks; "
                f"{cfg.arch_type} stacks are still to port (ROADMAP queue 1, item 17)")
        if attn_impl not in attn_mod.IMPLS:
            raise NotImplementedError(f"attention impl {attn_impl!r} is not ported; the port "
                                      f"has {attn_mod.IMPLS} (ROADMAP queue 1, item 17)")
        self.cfg, self.dtype, self.attn_impl = cfg, dtype, attn_impl
        self.device = resolve_device(device)
        if generator is not None and generator.device != self.device:
            raise ValueError(f"the generator lies on {generator.device}, the model on "
                             f"{self.device}")
        defs = _block_defs(cfg)

        def empty(shape):
            return torch.empty(shape, dtype=dtype, device=self.device)

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        if generator is None:
            blocks = [{n: empty(p.shape) for n, p in defs.items()} for _ in range(cfg.num_layers)]
            embed = empty((cfg.vocab_size, cfg.d_model))
            head = None if cfg.tie_embeddings else empty((cfg.d_model, cfg.vocab_size))
        else:
            embed = (0.02 * torch.randn(cfg.vocab_size, cfg.d_model, generator=generator,
                                        device=self.device)).to(dtype)
            blocks = [init_params(generator, defs, dtype) for _ in range(cfg.num_layers)]
            head = None if cfg.tie_embeddings else (
                torch.randn(cfg.d_model, cfg.vocab_size, generator=generator, device=self.device)
                / cfg.d_model ** 0.5).to(dtype)
        self.embed = param(embed)
        self.final_norm = param(torch.zeros(cfg.d_model, dtype=dtype, device=self.device))
        self.blocks = nn.ModuleList(
            nn.ParameterDict({n: param(t) for n, t in b.items()}) for b in blocks)
        self.head = None if head is None else param(head)

    # --------------------------------------------------------------- blocks

    def _apply_block(self, bp, x, *, positions, cache=None, decode_pos=None):
        cfg = self.cfg
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        if cfg.arch_type == "ssm":
            y, cache = ssm_mod.ssm_apply(bp, h, cfg, cache=cache, impl=self.attn_impl)
            return x + y, cache
        a, cache = attn_mod.attention_apply(bp, h, cfg, positions=positions, cache=cache,
                                            decode_pos=decode_pos, impl=self.attn_impl)
        if cfg.parallel_block:
            m = rms_norm(x, bp["ln2"], cfg.norm_eps)
            return x + a + mlp_mod.mlp_apply(bp, m, cfg), cache
        x = x + a
        m = rms_norm(x, bp["ln2"], cfg.norm_eps)
        return x + mlp_mod.mlp_apply(bp, m, cfg), cache

    def _stack(self, x, *, positions, caches=None, decode_pos=None):
        """Run all blocks.  caches: None, or {"blocks": [one cache per layer]}."""
        for i, bp in enumerate(self.blocks):
            x, _ = self._apply_block(bp, x, positions=positions,
                                     cache=None if caches is None else caches["blocks"][i],
                                     decode_pos=decode_pos)
        return x

    # -------------------------------------------------------------- forward

    def _embed(self, tokens, positions):
        x = self.embed[tokens].to(self.dtype)
        if not self.cfg.use_rope:
            pe = sinusoidal_positions(self.max_positions, self.cfg.d_model, self.dtype,
                                      device=x.device)
            x = x + pe[positions.clamp(max=self.max_positions - 1)]
        return x

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Final-normed hidden states (B, S, d) of ``tokens`` (B, S)."""
        positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        x = self._stack(self._embed(tokens, positions), positions=positions)
        return rms_norm(x, self.final_norm, self.cfg.norm_eps)

    def _head_matrix(self):
        return self.embed.T if self.cfg.tie_embeddings else self.head

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self._head_matrix()

    # ------------------------------------------------------------- serving

    def init_cache(self, batch: int, seq_len: int) -> dict:
        """One cache per layer on the model's device: a KV cache in the model's
        dtype, or for an SSM stack a conv window and a state in float32 whatever
        the model's dtype (``seq_len`` unused), as the JAX package keeps them."""
        cfg, layers = self.cfg, range(self.cfg.num_layers)
        if cfg.arch_type == "ssm":
            return {"blocks": [ssm_mod.init_ssm_cache(cfg, batch, device=self.device)
                               for _ in layers]}
        return {"blocks": [attn_mod.init_kv_cache(cfg, batch, seq_len, self.dtype, self.device)
                           for _ in layers]}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, caches: dict):
        """Logits (B, V) of the last prompt position; fills ``caches`` in place."""
        positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        x = self._stack(self._embed(tokens, positions), positions=positions, caches=caches)
        h = rms_norm(x[:, -1:], self.final_norm, self.cfg.norm_eps)
        return self.logits(h)[:, 0], caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, pos: int, caches: dict):
        """token: (B,) ids; pos: the position of ``token`` (uniform across the batch)."""
        positions = torch.full((token.shape[0], 1), int(pos), dtype=torch.int32,
                               device=token.device)
        x = self._stack(self._embed(token[:, None], positions), positions=positions,
                        caches=caches, decode_pos=int(pos))
        h = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.logits(h)[:, 0], caches
