"""Control-variate server algorithm: DP-SCAFFOLD (counterpart of
repro/core/variance_reduction.py).

SCAFFOLD (Karimireddy et al. 2020) removes client drift with control
variates: client i steps with ``g - c_i + c`` and refreshes its variate by
option II, ``c_i+ = c_i - c + (w - y_i) / (tau * eta_l)``.  Under
client-level DP the client releases TWO vectors a round, the model update
``dy`` and the variate update ``dc``, each clipped and noised at std
``sigma * sqrt(2)`` (times the variate scale for ``dc``), so that the two
releases compose to exactly one release at std ``sigma`` (Noble et al.
2022).

``DPScaffoldServer`` keeps the per-client variates in the server carry
(``ScaffoldState``); the round hands each block of clients its variate rows
through ``local_context`` (``fedsim/server.py::local_caller``), and the two
releases ride the dense round and the masked-moment round.

Both releases reduce through ``fused_clip_aggregate`` (dense) or
``partial_clip_moments`` (masked), so on the card a round is two
``dp_aggregate`` launches:

    model release     the raw dy rows, clip C; LDP: fused noise of std
                      sigma sqrt(2) under the round's first seed; CDP: none
                      mode, then (d,) noise on the mean.
    variate release   ``dc_clip = clip_batch(dc, C vs)`` once in plain torch
                      (the table keeps these very rows), then the kernel at
                      C = inf; LDP: fused noise of std sigma sqrt(2) vs
                      under the second seed; CDP: none mode.

The noise of client i is keyed by (seed, i, column pair) as every Gaussian
release's, so a gathered block draws its clients' rows of the dense draw.
A masked round with a multiplicity mask (a fixed cohort drawn with
replacement) weights each row by its multiplicity, as the reference's
``mask @ rows`` does: each draw of a client becomes a row of its own (its
rows repeated, keyed by its client index, so its noise repeats too), and the
two releases are still two kernel launches.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import accounting
from repro_torch.core.aggregation import (
    fused_clip_aggregate,
    global_client_indices,
    partial_clip_moments,
)
from repro_torch.core.algorithm import (
    RoundAux,
    RoundNoise,
    ServerAlgorithm,
    device_normal,
    draw_seed32,
    rows_at,
)
from repro_torch.core.clipping import clip_batch

__all__ = ["ScaffoldState", "DPScaffoldServer", "multiplicity_rows"]


def multiplicity_rows(mask: torch.Tensor) -> torch.Tensor:
    """(n,) int64 rows of a host multiplicity mask, row i ``mask[i]`` times
    (DP-SCAFFOLD's ``draws`` of a with-replacement cohort), on the host."""
    return torch.repeat_interleave(torch.arange(mask.shape[0]), mask.to(torch.int64))


@dataclasses.dataclass
class ScaffoldState:
    """Server carry of a control-variate run: the global variate ``c`` (d,)
    and the per-client variate table ``c_is`` (num_clients, d)."""

    c: torch.Tensor
    c_is: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DPScaffoldServer(ServerAlgorithm):
    """DP-SCAFFOLD (Noble, Bellet, Dieuleveut, AISTATS 2022): two clipped and
    noised releases a round over the control-variate local trainer
    (``LocalSpec(control_variates=True)``).

    ``central=True`` noises the two means on the server at
    ``sigma sqrt(2) / sqrt(num_clients)`` (CDP); ``central=False`` noises
    each client's releases at ``sigma sqrt(2)`` (LDP).  eta_g is pinned to 1:
    SCAFFOLD has no extrapolation rule.  ``backend`` is the Gaussian names'
    (``fused_clip_aggregate``).
    """

    clip_norm: float
    sigma: float                 # baseline noise scale (as for DP-FedAvg)
    central: bool                # True: CDP noise on the means
    num_clients: int
    tau: int
    eta_l: float
    backend: str = "auto"

    name = "dp-scaffold"
    uses_local_context = True    # the round appends (c_i rows, c) to the trainer call

    def __post_init__(self):
        if self.clip_norm <= 0:
            raise ValueError(f"clip_norm must be positive, got {self.clip_norm}")
        if self.sigma < 0:
            raise ValueError(f"sigma must be >= 0, got {self.sigma}")
        if self.num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {self.num_clients}")
        if self.tau < 1:
            raise ValueError(f"tau must be >= 1, got {self.tau}")
        if self.eta_l <= 0:
            raise ValueError(f"eta_l must be positive, got {self.eta_l}")

    @property
    def variate_scale(self) -> float:
        """Option-II refresh scale 1/(tau * eta_l): dc = -c - vs * dy."""
        return 1.0 / (self.tau * self.eta_l)

    def comm_floats(self, d: int) -> int:
        """Floats a client sends a round: the two (d,) releases and three scalars."""
        return 2 * d + 3

    def init_state(self, w):
        """Zero variates on ``w``'s device."""
        return ScaffoldState(c=torch.zeros_like(w),
                             c_is=torch.zeros((self.num_clients, w.shape[-1]), dtype=w.dtype,
                                              device=w.device))

    def draw_noise(self, gen, m, d, device, t=None) -> RoundNoise:
        """The model release's randomness, then the variate release's: two
        32-bit seeds (LDP) or two (d,) N(0, 1) on the device (CDP)."""
        if self.central:
            first = device_normal(gen, (d,), device)
            return RoundNoise(central=first, central_dc=device_normal(gen, (d,), device))
        first = draw_seed32(gen)
        return RoundNoise(seed=first, seed_dc=draw_seed32(gen))

    # -- the trainer's context (fedsim/server.py::local_caller) -------------

    def local_context(self, state, start, m_local: int):
        """The variate rows of a block of ``m_local`` clients at ``start``, and
        the global variate: ``(c_i rows, c)``.

        ``start`` is 0 with the whole cohort (the table itself), an int (a
        contiguous block; rows past the table are zeros), or a (m_local,)
        host tensor of slots (a gathered block: rows ``min(slot, M - 1)``,
        indices copied to the device without a read back)."""
        c_is = state.c_is
        if isinstance(start, torch.Tensor):
            start = torch.clamp(start, max=c_is.shape[0] - 1)
        return rows_at(c_is, start, m_local), state.c

    def _dc(self, deltas, c_i, c):
        """Variate updates from the raw dy rows, in the reference's op order
        ``(c_i - c - vs * dy) - c_i`` (not the algebraic ``-c - vs * dy``)."""
        c_i_new = c_i - c - deltas * self.variate_scale
        return c_i_new - c_i

    # -- the dense round -----------------------------------------------------

    def apply_round(self, gen, w, raw_deltas, noise=None, t=None):
        """Refused: the round reads and writes the variate carry."""
        raise TypeError(f"{self.name} is stateful; use apply_round_stateful")

    def apply_round_stateful(self, gen, w, raw_deltas, state, noise=None, t=None):
        """Full-participation round: both releases of the (M, d) raw deltas,
        the variate table advanced by the clipped dc rows, w by the noised
        mean of dy (eta_g = 1)."""
        m, d = raw_deltas.shape
        if noise is None:
            noise = self.draw_noise(gen, m, d, raw_deltas.device, t)
        vs = self.variate_scale
        dc_clip = clip_batch(self._dc(raw_deltas, state.c_is, state.c), self.clip_norm * vs)
        if self.central:
            std = self.sigma * math.sqrt(2.0) / math.sqrt(self.num_clients)
            dy_bar = fused_clip_aggregate(raw_deltas, self.clip_norm, None,
                                          backend=self.backend).cbar + std * noise.central
            dc_bar = fused_clip_aggregate(dc_clip, math.inf, None, backend=self.backend).cbar \
                + std * vs * noise.central_dc
        else:
            std = self.sigma * math.sqrt(2.0)
            dy_bar = self._ldp_release(raw_deltas, self.clip_norm, noise.ldp, noise.seed, std)
            dc_bar = self._ldp_release(dc_clip, math.inf, noise.ldp_dc, noise.seed_dc, std * vs)
        state_next = ScaffoldState(c=state.c + dc_bar, c_is=state.c_is + dc_clip)
        return w + dy_bar, RoundAux(eta_g=torch.ones((), device=w.device)), state_next

    def _ldp_release(self, rows, clip, materialized, seed, std):
        """The mean of the clipped rows plus per-client noise of std ``std``:
        a materialized matrix when the caller gave one, else the seed's."""
        if materialized is not None:
            return fused_clip_aggregate(rows, clip, materialized, backend=self.backend).cbar
        return fused_clip_aggregate(rows, clip, noise_seed=seed, noise_sigma=std,
                                    backend=self.backend).cbar

    # -- the masked-moment round ---------------------------------------------

    def _moments(self, rows, clip, materialized, seed, std, gate, start):
        """A release's sums over the gated rows of a block at ``start``."""
        m = rows.shape[0]
        if materialized is not None:
            return partial_clip_moments(rows, clip, rows_at(materialized, start, m),
                                        weight_mask=gate, backend=self.backend)
        if seed is None:
            return partial_clip_moments(rows, clip, None, weight_mask=gate, backend=self.backend)
        return partial_clip_moments(rows, clip, noise_seed=seed, noise_sigma=std, start=start,
                                    weight_mask=gate, backend=self.backend)

    def local_moments(self, noise, w, deltas, mask, start, state, t=None, *,
                      binary_mask: bool = False, draws: torch.Tensor | None = None):
        """Partial sums of both releases over the masked rows of a block at
        ``start``: the model release as ``RoundMoments``; the variate
        release's sum and the variate table's increment (a fresh
        (num_clients, d) table of zeros plus each row's ``dc_clip * mask`` at
        its client's index) as extras.

        ``dc`` is gated before the clip: a masked row's would otherwise be
        ``-c``.  A {0, 1} mask (``binary_mask``) gates rows in the kernel.  A
        multiplicity mask comes with its expansion, ``draws`` (the round's
        stage makes it from the host mask: ``multiplicity_rows``, on the
        device): row i enters ``mask[i]`` times as rows of its own, keyed by
        its client, so each release is one launch over the drawn rows.  The
        drawn rows are gated by ``mask`` on the device: a row the stage drew
        but the device turned off (a faulted client, a finite screen) adds no
        noise and no count.

        The block's table rows are indexed on the device: a gathered block's
        slots (a tensor ``start``) all lie in the table, and of a contiguous
        block the rows before ``num_clients``."""
        m_local, d = deltas.shape
        vs = self.variate_scale
        dev = deltas.device
        if mask is None:   # every row in: a gate of ones, the dense round's values
            mask = deltas.new_ones(m_local)
        c_i = self.local_context(state, start, m_local)[0]
        dc = torch.where((mask > 0)[:, None], self._dc(deltas, c_i, state.c), 0.0)
        dc_clip = clip_batch(dc, self.clip_norm * vs)
        gidx = global_client_indices(start, m_local, dev)
        # a streamed chunk's padding rows past M (mask 0) have no table row
        inside = m_local if isinstance(start, torch.Tensor) else \
            max(0, min(m_local, self.num_clients - int(start)))
        cis_add = torch.zeros((self.num_clients, d), dtype=dc_clip.dtype, device=dev) \
            .index_add_(0, gidx[:inside], (dc_clip * mask[:, None])[:inside])
        rows_dy, rows_dc, keys, gate = deltas, dc_clip, start, mask
        if not binary_mask:
            if draws is None:
                raise ValueError("a multiplicity mask needs its expanded rows (draws=, "
                                 "multiplicity_rows of the host mask)")
            rows_dy, rows_dc = deltas.index_select(0, draws), dc_clip.index_select(0, draws)
            keys, gate = gidx[draws], (mask.index_select(0, draws) > 0).to(mask.dtype)
        ldp = not self.central
        std = self.sigma * math.sqrt(2.0)
        mom = self._moments(rows_dy, self.clip_norm, noise.ldp if ldp else None,
                            noise.seed if ldp else None, std, gate, keys)
        dc_mom = self._moments(rows_dc, math.inf, noise.ldp_dc if ldp else None,
                               noise.seed_dc if ldp else None, std * vs, gate, keys)
        return mom, {"sum_dc": dc_mom.sum_c, "cis_add": cis_add}

    def apply_from_moments(self, noise, w, moments, state, t=None):
        """The server update from the cohort's moments; the CDP noise std
        divides by the static ``num_clients``, not the realised count."""
        mom, extras = moments
        dy_bar = mom.sum_c / mom.count
        dc_bar = extras["sum_dc"] / mom.count
        if self.central:
            std = self.sigma * math.sqrt(2.0) / math.sqrt(self.num_clients)
            dy_bar = dy_bar + std * noise.central
            dc_bar = dc_bar + std * self.variate_scale * noise.central_dc
        state_next = ScaffoldState(c=state.c + dc_bar, c_is=state.c_is + extras["cis_add"])
        return w + dy_bar, RoundAux(eta_g=torch.ones((), device=w.device)), state_next

    # -- accounting ------------------------------------------------------------

    def budget(self, delta: float, *, rounds: int, dim: int | None = None,
               sampling_q: float = 1.0) -> accounting.PrivacyReport:
        """The two releases (std sigma sqrt(2), and sigma sqrt(2) vs against
        sensitivity 2 C vs) compose to exactly one release at std sigma, so
        the report is the single-release curve's."""
        if self.sigma <= 0:
            raise ValueError(f"{self.name} with sigma=0 is not private")
        if self.central:
            rep = accounting.cdp_budget(self.clip_norm, self.sigma, self.num_clients, rounds,
                                        delta, sampling_q=sampling_q)
            return dataclasses.replace(rep, setting="CDP (Gaussian, SCAFFOLD two-release)")
        rep = accounting.ldp_gaussian_budget(self.clip_norm, self.sigma, delta)
        return dataclasses.replace(rep, setting="LDP (Gaussian, SCAFFOLD two-release)")
