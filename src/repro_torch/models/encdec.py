"""Whisper-style encoder-decoder, the ``audio`` stack (counterpart of
repro/models/encdec.py).

The mel-spectrogram and convolutional frontend is a stub, as in the JAX
package: the encoder takes precomputed frame embeddings (B, T, d_model).

  encoder: layers of non-causal self-attention and a GELU MLP
  decoder: layers of causal self-attention, cross-attention to the encoder's
           output and a GELU MLP

Both add sinusoidal absolute positions (the table computed in float32 and
cast to the model's dtype); every norm is a layer norm with a bias.  The JAX
package stacks each side's blocks on a leading L axis and scans them; here
each block is an ``nn.ParameterDict`` with the JAX package's parameter names
and the layers run in a Python loop.  Self-attention takes ``attn_impl``'s
path (``"kernel"``: the flash kernel, non-causal in the encoder and causal in
the decoder's prefill); cross-attention takes the plain paths whatever
``attn_impl`` is, as in the JAX package (``attention.attention_apply``).

Every ``decode`` call computes each layer's cross-attention K and V from the
encoder's output, as the JAX package does.  Serving (``encode``, ``decode``,
``decode_step``) reads the module's own parameters under ``torch.no_grad``;
training goes through the functional ``loss(params, frames, tokens,
labels)``, ``params`` a dict named as ``named_parameters()`` ("embed",
"enc_blocks.<i>.<name>", "dec_blocks.<i>.<name>", "enc_norm", "enc_norm_b",
"dec_norm", "dec_norm_b").
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (Param, init_params, layer_norm, logical_specs,
                                       sinusoidal_positions)
from repro_torch.models.transformer import _chunk_nll

__all__ = ["EncDecLM", "enc_block_defs", "dec_block_defs"]

NORMS = ("enc_norm", "enc_norm_b", "dec_norm", "dec_norm_b")


def enc_block_defs(cfg: ModelConfig) -> dict[str, Param]:
    """Parameter defs of ONE encoder block."""
    return {
        "ln1": Param((cfg.d_model,), (None,)), "ln1_b": Param((cfg.d_model,), (None,)),
        "ln2": Param((cfg.d_model,), (None,)), "ln2_b": Param((cfg.d_model,), (None,)),
        **attn_mod.attention_defs(cfg, "attn_"),
        **mlp_mod.mlp_defs(cfg, "mlp_"),
    }


def dec_block_defs(cfg: ModelConfig) -> dict[str, Param]:
    """Parameter defs of ONE decoder block: self-attention (``attn_*``) and
    cross-attention (``xattn_*``), each with biases where ``use_bias`` adds them."""
    return {
        "ln1": Param((cfg.d_model,), (None,)), "ln1_b": Param((cfg.d_model,), (None,)),
        "ln2": Param((cfg.d_model,), (None,)), "ln2_b": Param((cfg.d_model,), (None,)),
        "ln3": Param((cfg.d_model,), (None,)), "ln3_b": Param((cfg.d_model,), (None,)),
        **attn_mod.attention_defs(cfg, "attn_"),
        **attn_mod.attention_defs(cfg, "xattn_"),
        **mlp_mod.mlp_defs(cfg, "mlp_"),
    }


class EncDecLM(nn.Module):
    """Whisper's encoder-decoder.

    ``generator`` (a ``torch.Generator`` on ``device``) draws the initial
    weights as the JAX package's ``EncDecLM.init`` does (the same
    distributions, not the same values); with ``generator=None`` they are left
    uninitialised, to be filled by ``repro_torch.convert.encdec_from_jax``.
    ``attn_impl`` is one of ``attention.IMPLS``, as for ``DecoderLM``; only
    the plain paths train.  ``remat`` recomputes each block in the backward
    pass.  The model runs on the card unless ``device`` says otherwise.
    """

    max_positions = 32_768   # the decoder's sinusoidal table, as in the JAX package

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, attn_impl: str = "kernel",
                 remat: bool = True, device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        if cfg.arch_type != "audio":
            raise ValueError(f"{cfg.name}: EncDecLM runs audio (enc-dec) stacks, not "
                             f"{cfg.arch_type}; build a DecoderLM")
        if attn_impl not in attn_mod.IMPLS:
            raise ValueError(f"unknown attention impl {attn_impl!r}; the port has "
                             f"{attn_mod.IMPLS}")
        self.cfg, self.dtype, self.attn_impl, self.remat = cfg, dtype, attn_impl, remat
        self.device = resolve_device(device)
        if generator is not None and generator.device != self.device:
            raise ValueError(f"the generator lies on {generator.device}, the model on "
                             f"{self.device}")
        sides = ((enc_block_defs(cfg), cfg.num_encoder_layers),
                 (dec_block_defs(cfg), cfg.num_layers))
        if generator is None:
            embed = torch.empty(cfg.vocab_size, cfg.d_model, dtype=dtype, device=self.device)
            enc, dec = ([{n: torch.empty(p.shape, dtype=dtype, device=self.device)
                          for n, p in defs.items()} for _ in range(layers)]
                        for defs, layers in sides)
        else:
            embed = (0.02 * torch.randn(cfg.vocab_size, cfg.d_model, generator=generator,
                                        device=self.device)).to(dtype)
            enc, dec = ([init_params(generator, defs, dtype) for _ in range(layers)]
                        for defs, layers in sides)

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        self.embed = param(embed)
        self.enc_blocks = nn.ModuleList(
            nn.ParameterDict({n: param(t) for n, t in b.items()}) for b in enc)
        self.dec_blocks = nn.ModuleList(
            nn.ParameterDict({n: param(t) for n, t in b.items()}) for b in dec)
        for name in NORMS:
            setattr(self, name, param(torch.zeros(cfg.d_model, dtype=dtype, device=self.device)))

    def _remat(self, fn, cached: bool = False):
        """``fn`` recomputed in the backward pass when ``remat`` is on, no
        cache is filled and autograd is on."""
        if self.remat and not cached and torch.is_grad_enabled():
            return functools.partial(checkpoint, fn, use_reentrant=False)
        return fn

    def pspecs(self) -> dict:
        """The logical axes of every parameter, in the JAX package's tree
        (the blocks with a leading "layers" axis; see ``DecoderLM.pspecs``)."""
        cfg = self.cfg

        def stacked(defs):
            return {k: ("layers",) + v for k, v in logical_specs(defs).items()}

        return {"embed": ("vocab", "embed"), "enc_blocks": stacked(enc_block_defs(cfg)),
                "dec_blocks": stacked(dec_block_defs(cfg)),
                **{name: (None,) for name in NORMS}}

    # ---------------------------------------------------------------- encoder

    def _enc_block(self, bp, h, *, positions):
        cfg = self.cfg
        a_in = layer_norm(h, bp["ln1"], bp["ln1_b"], cfg.norm_eps)
        a, _ = attn_mod.attention_apply(bp, a_in, cfg, positions=positions, causal=False,
                                        impl=self.attn_impl)
        h = h + a
        m = layer_norm(h, bp["ln2"], bp["ln2_b"], cfg.norm_eps)
        return h + mlp_mod.mlp_apply(bp, m, cfg)

    def _encode(self, frames, blocks, norm, norm_b):
        cfg = self.cfg
        t = frames.shape[1]
        pe = sinusoidal_positions(t, cfg.d_model, self.dtype, device=frames.device)
        x = frames.to(self.dtype) + pe[None]
        positions = torch.arange(t, device=frames.device).expand(frames.shape[:2])
        body = self._remat(self._enc_block)
        for bp in blocks:
            x = body(bp, x, positions=positions)
        return layer_norm(x, norm, norm_b, cfg.norm_eps)

    @torch.no_grad()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder's output (B, T, d_model) of ``frames`` (B, T, d_model),
        the stubbed frontend's frame embeddings."""
        return self._encode(frames, self.enc_blocks, self.enc_norm, self.enc_norm_b)

    def _cross_kv(self, bp, enc_out):
        """One decoder layer's cross-attention (k, v), each (B, T, Hkv, Dh)."""
        cfg = self.cfg
        dh, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
        b, t, _ = enc_out.shape
        k = (enc_out @ bp["xattn_wk"]).reshape(b, t, hkv, dh)
        v = (enc_out @ bp["xattn_wv"]).reshape(b, t, hkv, dh)
        if "xattn_wv_b" in bp:
            v = v + bp["xattn_wv_b"].reshape(hkv, dh)
        return k, v

    @torch.no_grad()
    def cross_kv(self, enc_out: torch.Tensor) -> list:
        """Every decoder layer's cross-attention (k, v) of ``enc_out``."""
        return [self._cross_kv(bp, enc_out) for bp in self.dec_blocks]

    # ---------------------------------------------------------------- decoder

    def _dec_block(self, bp, h, enc_out, *, positions, cache=None, decode_pos=None):
        cfg = self.cfg
        a_in = layer_norm(h, bp["ln1"], bp["ln1_b"], cfg.norm_eps)
        a, cache = attn_mod.attention_apply(bp, a_in, cfg, positions=positions, cache=cache,
                                            decode_pos=decode_pos, impl=self.attn_impl,
                                            prefix="attn_")
        h = h + a
        x_in = layer_norm(h, bp["ln2"], bp["ln2_b"], cfg.norm_eps)
        xa, _ = attn_mod.attention_apply(bp, x_in, cfg, positions=positions,
                                         cross_kv=self._cross_kv(bp, enc_out),
                                         impl=self.attn_impl, prefix="xattn_")
        h = h + xa
        m = layer_norm(h, bp["ln3"], bp["ln3_b"], cfg.norm_eps)
        return h + mlp_mod.mlp_apply(bp, m, cfg), cache

    def _decode(self, tokens, enc_out, embed, blocks, norm, norm_b, caches=None,
                decode_pos=None):
        """The final-normed decoder states (B, S, d_model)."""
        cfg = self.cfg
        b, s = tokens.shape
        if decode_pos is None:
            positions, rows = torch.arange(s, device=tokens.device).expand(b, s), s
        else:
            positions = torch.full((b, s), int(decode_pos), dtype=torch.int32,
                                   device=tokens.device)
            rows = int(decode_pos) + 1
        # the rows of the max_positions table that positions reach (each row
        # depends on its position alone), positions clamped to its last
        pe = sinusoidal_positions(min(rows, self.max_positions), cfg.d_model, self.dtype,
                                  device=tokens.device)
        x = embed[tokens].to(self.dtype) + pe[positions.clamp(max=self.max_positions - 1)]
        body = self._remat(self._dec_block, cached=caches is not None)
        for i, bp in enumerate(blocks):
            x, _ = body(bp, x, enc_out, positions=positions, decode_pos=decode_pos,
                        cache=None if caches is None else caches["blocks"][i])
        return layer_norm(x, norm, norm_b, cfg.norm_eps)

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, enc_out: torch.Tensor, caches: dict | None = None,
               decode_pos: int | None = None):
        """(logits (B, S, V), caches): the teacher-forced forward of ``tokens``
        (B, S) against ``enc_out`` without caches, or with ``caches`` a prefill
        from position 0 (a one-token ``tokens`` with ``decode_pos``: a decode
        step), which fills them in place."""
        h = self._decode(tokens, enc_out, self.embed, self.dec_blocks, self.dec_norm,
                         self.dec_norm_b, caches, decode_pos)
        return h @ self.embed.T, caches

    def decode_step(self, token: torch.Tensor, pos: int, enc_out: torch.Tensor, caches: dict):
        """token: (B,) ids; pos: the position of ``token`` (uniform across the
        batch).  (logits (B, V), caches)."""
        logits, caches = self.decode(token[:, None], enc_out, caches=caches, decode_pos=pos)
        return logits[:, 0], caches

    def init_cache(self, batch: int, seq_len: int) -> dict:
        """{"blocks": [a KV cache in the model's dtype per decoder layer]} on
        the model's device.  Cross-attention keeps no cache."""
        return {"blocks": [attn_mod.init_kv_cache(self.cfg, batch, seq_len, self.dtype,
                                                  self.device)
                           for _ in range(self.cfg.num_layers)]}

    # ---------------------------------------------------------------- training

    def _unflatten(self, params: dict):
        """``params`` (named as ``named_parameters()``) as (embed, encoder
        block dicts, decoder block dicts, the four norms); raises on missing or
        extra names."""
        want = [n for n, _ in self.named_parameters()]
        if set(params) != set(want):
            missing, extra = sorted(set(want) - set(params)), sorted(set(params) - set(want))
            raise ValueError(f"{self.cfg.name}: parameter names differ from "
                             f"named_parameters(): missing {missing[:4]}, extra {extra[:4]}")
        enc = [{n: params[f"enc_blocks.{i}.{n}"] for n in bp}
               for i, bp in enumerate(self.enc_blocks)]
        dec = [{n: params[f"dec_blocks.{i}.{n}"] for n in bp}
               for i, bp in enumerate(self.dec_blocks)]
        return params["embed"], enc, dec, [params[n] for n in NORMS]

    def loss(self, params: dict, frames: torch.Tensor, tokens: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy of the decoder on ``tokens`` (B, S)
        against ``labels`` (B, S; < 0 is ignored), given ``frames`` (B, T,
        d_model), under ``params``, a dict of tensors named as
        ``named_parameters()``: float32 logits, logsumexp, the label's logit,
        the sum over valid labels divided by their count floored at 1; a 0-d
        float32 tensor (the JAX package's ``EncDecLM.loss``).  With autograd
        on, ``"kernel"`` raises: the flash kernel has no backward."""
        if self.attn_impl == "kernel" and torch.is_grad_enabled():
            raise NotImplementedError(
                "attn_impl='kernel' does not train: the flash attention kernel has no backward, "
                "as the JAX package's Pallas kernel has none; train with 'xla_flash' (the JAX "
                "package's default), 'chunked' or 'dense'")
        embed, enc, dec, (enc_norm, enc_norm_b, dec_norm, dec_norm_b) = self._unflatten(params)
        enc_out = self._encode(frames, enc, enc_norm, enc_norm_b)
        h = self._decode(tokens, enc_out, embed, dec, dec_norm, dec_norm_b)
        total, count = _chunk_nll(h, labels, embed.T)
        return total / torch.clamp(count, min=1.0)
