"""Federated training of a decoder LM or an encoder-decoder: one DP-FedEXP
round over its parameter tree (counterpart of repro/launch/train.py).

``FederatedTrainer.make_train_step`` returns a ``train_step`` that runs one
federated round (Algorithms 1/2 of the paper) for a cohort of K clients:

  1. local training: each client runs tau SGD steps on its own token
     microbatches from the broadcast parameters (``DecoderLM.loss``, or
     ``EncDecLM.loss`` with the step's frames; autograd);
  2. per-client clipping by the global L2 norm of the update tree;
  3. the mechanism's release, leaf-wise: Gaussian noise per client (LDP), or
     on the mean (CDP);
  4. the FedEXP statistics: mean ||c_i||^2 and ||cbar||^2;
  5. the adaptive global step size (Eqs. 6/8) and the model update.

The server rule comes from ``repro_torch.core.fedexp.make_algorithm``, the
registry of the flat engines: the mechanism gives the clip threshold, the
noise and its scale, and the extrapolation rule.  Every cast is the JAX
package's: the clip scale in float32, each clipped leaf cast back to its
dtype, the client mean accumulated in float32 and cast (``jnp.mean`` over
bf16 leaves does so), the update applied in float32 and cast.

The JAX package vmaps the K clients; here they run one after another.  After
each client trains, its update's norm, its clipped (LDP: released) update
and the squared norms go into float32 running sums, so a round holds about
five model-sized tensors on the device (the parameters, a client's copy, its
gradient, the float32 sum) whatever K is.

The round's randomness comes from the caller's ``torch.Generator`` (on the
CPU): the CDP-FedEXP numerator's xi first (a host draw), then the leaf-wise
noise from a generator on the parameters' device seeded by one draw of it,
client by client and leaf by leaf in sorted name order.  ``draw_noise``
materializes the same draws; ``train_step(..., noise=)`` takes materialized
ones, such as the JAX package's ``_tree_noise`` draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core.aggregation import RoundStats
from repro_torch.core.algorithm import RoundNoise, device_generator
from repro_torch.core.compose import CentralGaussian, ComposedAlgorithm, GaussianLDP, NoPrivacy
from repro_torch.core.fedexp import make_algorithm
from repro_torch.fedsim.specs import TrainSpec

__all__ = ["FederatedTrainer", "TrainNoise"]

# mechanisms with a leaf-wise (tree) release: clip + Gaussian noise commute
# with flattening, so the flat-engine semantics transfer exactly.  PrivUnit
# does not (its cap sampler needs the whole flat vector) and stays flat-only.
_PYTREE_MECHANISMS = (NoPrivacy, GaussianLDP, CentralGaussian)


@dataclasses.dataclass
class TrainNoise:
    """One round's randomness, materialized.

    ``tree`` maps each parameter name to the noise added to it, already
    scaled by its std and cast to the parameter's dtype (the JAX package's
    ``_tree_noise``): for LDP a (K, *shape) tensor, client i's noise in row
    i; for CDP the noise of the mean, of the parameter's shape; None without
    noise.  ``xi`` is the N(0, 1) of the CDP-FedEXP numerator (0-d float32),
    else None."""

    tree: dict | None = None
    xi: torch.Tensor | None = None


def _sq_norm(leaves) -> torch.Tensor:
    """Sum of squares over all leaves, in float32."""
    return sum(torch.sum(torch.square(leaf.to(torch.float32))) for leaf in leaves)


class _Draws:
    """A round's noise in the order it is drawn, or a ``TrainNoise``'s."""

    def __init__(self, alg: ComposedAlgorithm, params: dict, generator, noise):
        self.params, self.noise = params, noise
        mech = alg.mechanism
        self.std = None
        if isinstance(mech, GaussianLDP):
            self.std = mech.sigma
        elif isinstance(mech, CentralGaussian):
            self.std = mech.sigma / math.sqrt(mech.num_clients)
        if noise is not None:
            self.xi = noise.xi
            return
        self.xi = (torch.randn((), generator=generator)
                   if alg.step.uses_extrapolation and mech.needs_xi_key else None)
        device = next(iter(params.values())).device
        self.gen = None if self.std is None else device_generator(generator, device)

    def leaf(self, name: str, client: int | None = None) -> torch.Tensor:
        """The noise of parameter ``name``: client ``client``'s (LDP), or the
        mean's (CDP, ``client=None``)."""
        p = self.params[name]
        if self.noise is not None:
            t = self.noise.tree[name]
            return (t if client is None else t[client]).to(p.device)
        draw = torch.randn(p.shape, generator=self.gen, dtype=torch.float32, device=p.device)
        return (self.std * draw).to(p.dtype)


@dataclasses.dataclass
class FederatedTrainer:
    """DP-FedEXP rounds over a ``DecoderLM``'s or an ``EncDecLM``'s
    parameters (a dict named as its ``named_parameters()``).  ``num_params``
    is d, for the hyperparameter-free sigma_xi.  The model must take a plain
    attention path: the kernels have no backward."""

    model: Any                      # DecoderLM | EncDecLM
    fed: FederatedConfig
    num_params: int

    def __post_init__(self):
        # one train_step is one round of tau local SGD steps at eta_l
        self.train = TrainSpec(rounds=1, tau=self.fed.local_steps, eta_l=self.fed.local_lr)
        if self.model.attn_impl == "kernel":
            raise ValueError(
                "FederatedTrainer trains through autograd and the model's attn_impl is "
                "'kernel', whose flash attention and SSD scan kernels have no backward (nor "
                "have the JAX package's Pallas kernels); build the model with "
                "attn_impl='xla_flash' (the JAX package's default), 'chunked' or 'dense'")

    # ------------------------------------------------------------------

    def server_algorithm(self, m_total: int) -> ComposedAlgorithm:
        """Resolve ``fed.algorithm`` to the composed server algorithm for a
        cohort of ``m_total`` clients — the flat engines' registry, restricted
        to what a stateless tree train_step can run."""
        fed = self.fed
        try:
            alg = make_algorithm(fed.algorithm, clip_norm=fed.clip_norm,
                                 sigma=fed.noise_sigma, num_clients=m_total)
        except KeyError as e:
            raise ValueError(
                f"unsupported datacenter algorithm {fed.algorithm!r}: {e}") from e
        if alg.step.stateful:
            raise ValueError(
                f"{fed.algorithm!r} carries server state (FedOpt moments / adaptive clip); "
                "the stateless datacenter train_step supports fixed-eta and FedEXP steps "
                "only — use the fedsim engines")
        if not isinstance(alg.mechanism, _PYTREE_MECHANISMS):
            raise ValueError(
                f"{fed.algorithm!r} uses {type(alg.mechanism).__name__}, which has no "
                "leaf-wise pytree release; the datacenter path supports NoPrivacy, "
                "GaussianLDP and CentralGaussian mechanisms")
        return alg

    def draw_noise(self, params: dict, cohort_k: int, generator: torch.Generator) -> TrainNoise:
        """The noise ``make_train_step(cohort_k)``'s step draws from
        ``generator`` for ``cohort_k`` clients, materialized (LDP: cohort_k
        model-sized tensors; for tests and small models)."""
        alg = self.server_algorithm(cohort_k * self.fed.virtual_clients)
        draws = _Draws(alg, params, generator, None)
        if draws.std is None:
            return TrainNoise(xi=draws.xi)
        names = sorted(params)
        if isinstance(alg.mechanism, GaussianLDP):
            per_client = [{n: draws.leaf(n, i) for n in names} for i in range(cohort_k)]
            tree = {n: torch.stack([c[n] for c in per_client]) for n in names}
        else:
            tree = {n: draws.leaf(n) for n in names}
        return TrainNoise(tree=tree, xi=draws.xi)

    # ------------------------------------------------------------------

    def _local_loss(self, leaves: dict, tokens, labels, frames):
        if frames is None:
            return self.model.loss(leaves, tokens, labels)
        return self.model.loss(leaves, frames, tokens, labels)

    def _local_train(self, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
                     frames: torch.Tensor | None = None):
        """tau local SGD steps (Algorithm 3) on (tau, b, s) token batches (and
        an enc-dec model's (tau, b, T, d_model) frames): (the update tree, the
        mean loss)."""
        eta_l = self.train.eta_l
        p, losses = params, []
        for step in range(tokens.shape[0]):
            leaves = {n: t.detach().requires_grad_() for n, t in p.items()}
            with torch.enable_grad():
                loss = self._local_loss(leaves, tokens[step], labels[step],
                                        None if frames is None else frames[step])
                grads = list(torch.autograd.grad(loss, list(leaves.values())))
            losses.append(loss.detach())
            p = {}
            with torch.no_grad():
                # leaf by leaf, dropping each old leaf and its gradient at once
                for j, n in enumerate(list(leaves)):
                    t = leaves.pop(n)
                    p[n] = t - eta_l * grads[j].to(t.dtype)
                    grads[j] = None
        with torch.no_grad():
            delta = {n: t.sub_(params[n]) for n, t in p.items()}
        return delta, torch.stack(losses).mean()

    def make_train_step(self, cohort_k: int):
        """``train_step(params, batch, generator, noise=None) -> (new_params,
        metrics)``.

        ``params``: a dict of tensors named as the model's
        ``named_parameters()``; ``batch``: ``{"tokens", "labels"}``, each (K,
        tau, b, s), and for an enc-dec model ``"frames"``, (K, tau, b, T,
        d_model); ``generator``: the round's ``torch.Generator`` on the CPU;
        ``noise``: a ``TrainNoise`` in place of the draws.  ``metrics``:
        ``loss``, ``eta_g``, ``mean_update_norm`` and ``agg_sq`` as in the JAX
        package, and ``client_norms`` (each update's norm) and
        ``clipped_norms`` (each clipped update's, before noise), all float32
        tensors on the parameters' device (nothing is read on the host)."""
        m_total = cohort_k * self.fed.virtual_clients
        alg = self.server_algorithm(m_total)
        mech = alg.mechanism
        d = self.num_params
        # the mechanism owns the clipping regime: None (NoPrivacy) = no clip
        clip = getattr(mech, "clip_norm", None)
        ldp = isinstance(mech, GaussianLDP)

        @torch.no_grad()
        def train_step(params: dict, batch: dict, generator: torch.Generator,
                       noise: TrainNoise | None = None):
            tokens, labels, frames = batch["tokens"], batch["labels"], batch.get("frames")
            k = tokens.shape[0]
            names = sorted(params)
            device = params[names[0]].device
            draws = _Draws(alg, params, generator, noise)
            sums = {n: torch.zeros(params[n].shape, dtype=torch.float32, device=device)
                    for n in names}
            losses, sqs, norms, clipped_norms, released_sq = [], [], [], [], []
            for i in range(k):
                delta, loss = self._local_train(params, tokens[i], labels[i],
                                                None if frames is None else frames[i])
                losses.append(loss)
                sqs.append(_sq_norm(delta.values()))
                norm = torch.sqrt(torch.clamp(sqs[-1], min=1e-24))
                norms.append(norm)
                scale = None if clip is None else torch.clamp(clip / norm, max=1.0)
                csq = rsq = 0.0
                for n in names:
                    c = delta.pop(n)
                    if scale is not None:
                        c = (c.to(torch.float32) * scale).to(c.dtype)
                    csq = csq + torch.sum(torch.square(c.to(torch.float32)))
                    if ldp:
                        c = c + draws.leaf(n, i)
                        rsq = rsq + torch.sum(torch.square(c.to(torch.float32)))
                    sums[n] += c.to(torch.float32)
                clipped_norms.append(torch.sqrt(csq))
                released_sq.append(rsq)
            norms = torch.stack(norms)
            if clip is None:
                mean_sq_clipped = torch.mean(torch.stack(sqs))
            else:
                mean_sq_clipped = torch.mean(torch.square(torch.clamp(norms, max=clip)))
            cbar = {}
            for n in names:
                cbar[n] = (sums.pop(n) / k).to(params[n].dtype)
                if isinstance(mech, CentralGaussian):
                    cbar[n] = cbar[n] + draws.leaf(n)
            mean_sq = torch.mean(torch.stack(released_sq)) if ldp else mean_sq_clipped
            agg_sq = _sq_norm(cbar.values())

            if alg.step.uses_extrapolation:
                # extrapolation reads only the scalar moments; the tree cbar
                # is applied below, so the stats row slot is a dummy
                stats = RoundStats(cbar=torch.zeros((), device=device), mean_sq=mean_sq,
                                   agg_sq=agg_sq, mean_sq_clipped=mean_sq_clipped)
                eta, _, _ = mech.extrapolation(RoundNoise(xi=draws.xi), stats, {}, d, None,
                                               float(m_total))
                eta = eta.to(device)
            else:
                eta = torch.tensor(alg.step.eta, dtype=torch.float32, device=device)

            new_params = {}
            for n in names:
                p = params[n]
                new_params[n] = (p.to(torch.float32)
                                 + eta * cbar.pop(n).to(torch.float32)).to(p.dtype)
            metrics = {
                "loss": torch.stack(losses).mean(),
                "eta_g": eta,
                "mean_update_norm": torch.mean(norms),
                "agg_sq": agg_sq,
                "client_norms": norms,
                "clipped_norms": torch.stack(clipped_norms),
            }
            return new_params, metrics

        return train_step
