"""Decoder-only LM of the model zoo: dense, MoE, SSM (Mamba2), hybrid
(zamba2) and VLM (chameleon) stacks (counterpart of
repro/models/transformer.py).

The JAX package stacks the blocks on a leading L axis and scans them; here
each block is an ``nn.ParameterDict`` with the JAX package's parameter names,
and the layers run in a plain Python loop.  A VLM stack is the dense block
(its image tokens share the vocabulary: early fusion).  The hybrid stack
runs super-blocks of ``hybrid_attn_every`` Mamba2 layers, each followed by
ONE weight-shared attention(+MLP) block, ``shared_attn``: the same tensors
at every site, so autograd sums their gradients over the sites, as the JAX
package's closed-over tied weights do.

Serving (``prefill``, ``decode_step``) reads the module's own parameters
under ``torch.no_grad``.  Training goes through the functional ``loss(params,
tokens, labels)``: ``params`` is a dict of tensors named as
``named_parameters()`` ("embed", "final_norm", "blocks.<i>.<name>",
"shared_attn.<name>", "head"), which autograd differentiates; the module's
own parameters never require grad.  ``remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``), as the JAX package's ``jax.checkpoint`` does,
and the LM head runs in chunks of ``loss_chunk`` positions, each recomputed
too, so the (tokens, vocab) logits never exist at once.  The hybrid's
remat recomputes its Mamba2 blocks and not the shared block, as the JAX
package's.  The audio (enc-dec) stack is ``encdec.EncDecLM``.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import Param, init_params, rms_norm, sinusoidal_positions

__all__ = ["DecoderLM"]

ARCHS = ("dense", "moe", "ssm", "hybrid", "vlm")
_MOE_AUX_COEF = 0.01
REMAT_POLICIES = (None, "dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the outputs of the weight products (x @ W
    folds to ``mm``; attention's products carry batch dims and are ``bmm``),
    recompute the rest, as ``dots_with_no_batch_dims_saveable`` does."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def block_defs(cfg: ModelConfig) -> dict[str, Param]:
    """Parameter defs for ONE block of the stack (a hybrid's Mamba2 block)."""
    if cfg.arch_type in ("ssm", "hybrid"):
        return {"ln1": Param((cfg.d_model,), (None,)), **ssm_mod.ssm_defs(cfg)}
    ffn = moe_mod.moe_defs(cfg) if cfg.arch_type == "moe" else mlp_mod.mlp_defs(cfg)
    return {
        "ln1": Param((cfg.d_model,), (None,)),
        "ln2": Param((cfg.d_model,), (None,)),
        **attn_mod.attention_defs(cfg),
        **ffn,
    }


def shared_attn_defs(cfg: ModelConfig) -> dict[str, Param]:
    """zamba2's weight-shared attention(+MLP) block (hybrid stacks only)."""
    return {
        "ln1": Param((cfg.d_model,), (None,)),
        "ln2": Param((cfg.d_model,), (None,)),
        **attn_mod.attention_defs(cfg),
        **mlp_mod.mlp_defs(cfg),
    }


class DecoderLM(nn.Module):
    """A dense, MoE, SSM (Mamba2), hybrid or VLM decoder LM.

    ``generator`` (a ``torch.Generator`` on ``device``) draws the initial
    weights as the JAX package's ``DecoderLM.init`` does (the same
    distributions, not the same values); with ``generator=None`` they are left
    uninitialised, to be filled by ``repro_torch.convert.decoder_from_jax``.
    ``attn_impl`` is one of ``attention.IMPLS``: ``"kernel"`` (the CUDA
    kernels on the card: flash attention, and the SSD scan in a Mamba2 block;
    the JAX package's ``"pallas"``), the serving default; or a plain
    path: ``"dense"``, ``"xla_flash"`` (the JAX package's default) or
    ``"chunked"`` attention, each with the chunked SSD ``ssd_chunked`` in a
    Mamba2 block.  Only the plain paths train: the kernels have no backward.
    ``remat``, ``remat_policy`` (None: recompute everything; ``"dots"``: keep
    the weight products) and ``loss_chunk`` are the JAX package's training
    knobs.  The model runs on the card unless ``device`` says otherwise.
    """

    max_positions = 32_768   # sinusoidal table rows (non-RoPE archs), as in the JAX package

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, attn_impl: str = "kernel",
                 remat: bool = True, remat_policy: str | None = None, loss_chunk: int = 512,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        if cfg.arch_type not in ARCHS:
            raise NotImplementedError(
                f"{cfg.name}: the port's DecoderLM runs {', '.join(ARCHS)} stacks; build "
                f"{cfg.arch_type} (enc-dec) stacks as repro_torch.models.EncDecLM "
                "(or through repro_torch.models.build_model)")
        if attn_impl not in attn_mod.IMPLS:
            raise ValueError(f"unknown attention impl {attn_impl!r}; the port has "
                             f"{attn_mod.IMPLS}")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got "
                             f"{remat_policy!r}")
        if loss_chunk < 1:
            raise ValueError(f"loss_chunk must be >= 1, got {loss_chunk}")
        self.cfg, self.dtype, self.attn_impl = cfg, dtype, attn_impl
        self.remat, self.remat_policy, self.loss_chunk = remat, remat_policy, loss_chunk
        self.device = resolve_device(device)
        if generator is not None and generator.device != self.device:
            raise ValueError(f"the generator lies on {generator.device}, the model on "
                             f"{self.device}")
        defs = block_defs(cfg)
        shared_defs = shared_attn_defs(cfg) if cfg.arch_type == "hybrid" else {}

        def empty(shape):
            return torch.empty(shape, dtype=dtype, device=self.device)

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        if generator is None:
            blocks = [{n: empty(p.shape) for n, p in defs.items()} for _ in range(cfg.num_layers)]
            embed = empty((cfg.vocab_size, cfg.d_model))
            shared = {n: empty(p.shape) for n, p in shared_defs.items()}
            head = None if cfg.tie_embeddings else empty((cfg.d_model, cfg.vocab_size))
        else:
            embed = (0.02 * torch.randn(cfg.vocab_size, cfg.d_model, generator=generator,
                                        device=self.device)).to(dtype)
            blocks = [init_params(generator, defs, dtype) for _ in range(cfg.num_layers)]
            shared = init_params(generator, shared_defs, dtype)
            head = None if cfg.tie_embeddings else (
                torch.randn(cfg.d_model, cfg.vocab_size, generator=generator, device=self.device)
                / cfg.d_model ** 0.5).to(dtype)
        self.embed = param(embed)
        self.final_norm = param(torch.zeros(cfg.d_model, dtype=dtype, device=self.device))
        self.blocks = nn.ModuleList(
            nn.ParameterDict({n: param(t) for n, t in b.items()}) for b in blocks)
        self.shared_attn = nn.ParameterDict({n: param(t) for n, t in shared.items()}) \
            if shared_defs else None
        self.head = None if head is None else param(head)

    # --------------------------------------------------------------- blocks

    def _apply_block(self, bp, x, *, positions, cache=None, decode_pos=None):
        """One block of the stack: (x, cache, the MoE aux loss or 0.0)."""
        cfg = self.cfg
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        if cfg.arch_type in ("ssm", "hybrid"):
            y, cache = ssm_mod.ssm_apply(bp, h, cfg, cache=cache, impl=self.attn_impl)
            return x + y, cache, 0.0
        a, cache = attn_mod.attention_apply(bp, h, cfg, positions=positions, cache=cache,
                                            decode_pos=decode_pos, impl=self.attn_impl)
        if not cfg.parallel_block:
            x = x + a
        m = rms_norm(x, bp["ln2"], cfg.norm_eps)
        if cfg.arch_type == "moe":
            f, aux = moe_mod.moe_apply(bp, m, cfg)
        else:
            f, aux = mlp_mod.mlp_apply(bp, m, cfg), 0.0
        return (x + a + f if cfg.parallel_block else x + f), cache, aux

    def _apply_shared_attn(self, sp, x, *, positions, cache=None, decode_pos=None):
        """The hybrid's weight-shared attention(+MLP) block at one site."""
        cfg = self.cfg
        h = rms_norm(x, sp["ln1"], cfg.norm_eps)
        a, cache = attn_mod.attention_apply(sp, h, cfg, positions=positions, cache=cache,
                                            decode_pos=decode_pos, impl=self.attn_impl)
        x = x + a
        m = rms_norm(x, sp["ln2"], cfg.norm_eps)
        return x + mlp_mod.mlp_apply(sp, m, cfg), cache

    def _stack(self, x, *, positions, caches=None, decode_pos=None, blocks=None, shared=None):
        """Run all blocks: (x, the summed MoE aux loss).  ``blocks``: per-layer
        weight dicts and ``shared`` the hybrid's shared block, default the
        module's.  caches: None, or the dict of ``init_cache``.  With
        ``remat``, no cache and autograd on, each block of the stack (a
        hybrid's Mamba2 blocks, not its shared block) is recomputed in the
        backward pass."""
        blocks = self.blocks if blocks is None else blocks
        shared = self.shared_attn if shared is None else shared
        body = self._apply_block
        if self.remat and caches is None and torch.is_grad_enabled():
            context = (functools.partial(create_selective_checkpoint_contexts, _save_dots)
                       if self.remat_policy == "dots" else noop_context_fn)
            body = functools.partial(checkpoint, self._apply_block, use_reentrant=False,
                                     context_fn=context)
        layer_caches = None if caches is None else caches[
            "ssm" if self.cfg.arch_type == "hybrid" else "blocks"]
        every = self.cfg.hybrid_attn_every if self.cfg.arch_type == "hybrid" else 0
        if every and len(blocks) % every:
            # the JAX package reshapes the (L, ...) stack to (L // every, every, ...)
            raise ValueError(f"{self.cfg.name}: cannot group {len(blocks)} layers into "
                             f"super-blocks of hybrid_attn_every = {every}")
        aux = 0.0
        for i, bp in enumerate(blocks):
            x, _, aux_i = body(bp, x, positions=positions,
                               cache=None if layer_caches is None else layer_caches[i],
                               decode_pos=decode_pos)
            if torch.is_tensor(aux_i):      # an MoE block's; the others add 0.0
                aux = aux + aux_i
            if every and (i + 1) % every == 0:
                x, _ = self._apply_shared_attn(
                    shared, x, positions=positions, decode_pos=decode_pos,
                    cache=None if caches is None else caches["attn"][i // every])
        return x, aux

    # -------------------------------------------------------------- forward

    def _embed(self, embed, tokens, positions):
        x = embed[tokens].to(self.dtype)
        if not self.cfg.use_rope:
            pe = sinusoidal_positions(self.max_positions, self.cfg.d_model, self.dtype,
                                      device=x.device)
            x = x + pe[positions.clamp(max=self.max_positions - 1)]
        return x

    def _hidden(self, tokens, embed, final_norm, blocks, shared):
        """(final-normed hidden states, the summed MoE aux loss or 0.0)."""
        positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        x, aux = self._stack(self._embed(embed, tokens, positions), positions=positions,
                             blocks=blocks, shared=shared)
        return rms_norm(x, final_norm, self.cfg.norm_eps), aux

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Final-normed hidden states (B, S, d) of ``tokens`` (B, S)."""
        return self._hidden(tokens, self.embed, self.final_norm, self.blocks,
                            self.shared_attn)[0]

    def _head_matrix(self):
        return self.embed.T if self.cfg.tie_embeddings else self.head

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self._head_matrix()

    # ------------------------------------------------------------ training

    def _unflatten(self, params: dict):
        """``params`` (named as ``named_parameters()``) as (embed, final_norm,
        head matrix, per-layer block dicts, the shared block's dict or None);
        raises on missing or extra names."""
        want = [n for n, _ in self.named_parameters()]
        if set(params) != set(want):
            missing, extra = sorted(set(want) - set(params)), sorted(set(params) - set(want))
            raise ValueError(f"{self.cfg.name}: parameter names differ from "
                             f"named_parameters(): missing {missing[:4]}, extra {extra[:4]}")
        blocks = [{n: params[f"blocks.{i}.{n}"] for n in bp} for i, bp in enumerate(self.blocks)]
        shared = None if self.shared_attn is None else {
            n: params[f"shared_attn.{n}"] for n in self.shared_attn}
        head = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        return params["embed"], params["final_norm"], head, blocks, shared

    def loss(self, params: dict, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy of ``tokens`` (B, S) against ``labels``
        (B, S; -1 is ignored) under ``params``, a dict of tensors named as
        ``named_parameters()``; a float32 0-d tensor (the JAX package's
        ``DecoderLM.loss``).

        The final-normed forward, then the LM head a chunk of ``loss_chunk``
        positions at a time (the tail padded with zero states and -1 labels),
        each chunk recomputed in the backward pass: float32 logits, logsumexp,
        the label's logit.  The summed loss over the valid labels is divided by
        their count floored at 1, plus ``_MOE_AUX_COEF`` (0.01) times the MoE
        blocks' summed load-balance loss (0 in the other stacks).
        The kernel paths have no backward: with autograd on, ``"kernel"``
        raises."""
        if self.attn_impl == "kernel" and torch.is_grad_enabled():
            raise NotImplementedError(
                "attn_impl='kernel' does not train: the flash attention and SSD scan kernels "
                "have no backward, as the JAX package's Pallas kernels have none; train with "
                "'xla_flash' (the JAX package's default), 'chunked' or 'dense'")
        embed, final_norm, w, blocks, shared = self._unflatten(params)
        h, aux = self._hidden(tokens, embed, final_norm, blocks, shared)
        s = h.shape[1]
        chunk = min(self.loss_chunk, s)
        pad = (-s) % chunk
        if pad:
            h = torch.nn.functional.pad(h, (0, 0, 0, pad))
            labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        count = torch.zeros((), dtype=torch.float32, device=h.device)
        for i0 in range(0, s + pad, chunk):
            hh, ll = h[:, i0:i0 + chunk], labels[:, i0:i0 + chunk]
            if torch.is_grad_enabled():
                nll, n = checkpoint(_chunk_nll, hh, ll, w, use_reentrant=False)
            else:
                nll, n = _chunk_nll(hh, ll, w)
            total, count = total + nll, count + n
        return total / torch.clamp(count, min=1.0) + _MOE_AUX_COEF * aux

    # ------------------------------------------------------------- serving

    def init_cache(self, batch: int, seq_len: int) -> dict:
        """One cache per layer on the model's device, as the JAX package keeps
        them: {"blocks": [...]}, a KV cache in the model's dtype per attention
        layer, or a conv window and a state in float32 whatever the model's
        dtype per Mamba2 layer (``seq_len`` unused); a hybrid stack's is
        {"ssm": [one per Mamba2 layer], "attn": [a KV cache per site of the
        shared block]}."""
        cfg, layers = self.cfg, range(self.cfg.num_layers)

        def kv():
            return attn_mod.init_kv_cache(cfg, batch, seq_len, self.dtype, self.device)

        def ssm():
            return ssm_mod.init_ssm_cache(cfg, batch, device=self.device)

        if cfg.arch_type == "hybrid":
            return {"ssm": [ssm() for _ in layers],
                    "attn": [kv() for _ in range(cfg.num_layers // cfg.hybrid_attn_every)]}
        return {"blocks": [ssm() if cfg.arch_type == "ssm" else kv() for _ in layers]}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, caches: dict):
        """Logits (B, V) of the last prompt position; fills ``caches`` in place."""
        positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        x, _ = self._stack(self._embed(self.embed, tokens, positions), positions=positions,
                           caches=caches)
        h = rms_norm(x[:, -1:], self.final_norm, self.cfg.norm_eps)
        return self.logits(h)[:, 0], caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, pos: int, caches: dict):
        """token: (B,) ids; pos: the position of ``token`` (uniform across the batch)."""
        positions = torch.full((token.shape[0], 1), int(pos), dtype=torch.int32,
                               device=token.device)
        x, _ = self._stack(self._embed(self.embed, token[:, None], positions),
                           positions=positions, caches=caches, decode_pos=int(pos))
        h = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.logits(h)[:, 0], caches


def _chunk_nll(h: torch.Tensor, labels: torch.Tensor, w: torch.Tensor):
    """(summed negative log-likelihood, count) of one chunk's valid labels,
    from float32 logits."""
    logits = (h @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    valid = (labels >= 0).float()
    return torch.sum((lse - gold) * valid), torch.sum(valid)
