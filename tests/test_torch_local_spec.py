"""The port's LocalSpec trainers (minibatch SGD over local epochs, FedProx,
client momentum) against the JAX package's, on the CPU.

``local_update_spec`` and ``cohort_updates_spec`` take the same data and
weights as JAX's; a minibatch trainer takes JAX's own permutations
(``jax.random.permutation(fold_in(key, e), n)`` of each client's key, fed
through ``perms=``), since the port draws its shuffles from its own
Threefry keys (``local_shuffles``).  The port's shuffles are held to what
they promise: deterministic, different across rounds and clients, a
gathered block's rows equal to the dense round's, independent of the block
split.  Sessions: sigma = 0 full-batch prox and momentum runs against JAX's;
minibatch runs resumed, batched over seeds, gathered and faulted against
``run``; the straggler cutoff at TrainSpec.tau that JAX applies to every
trainer under a fault model.  Float32 at rtol 1e-5, a vector's atol 1e-5
times its largest entry (sums in other orders).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.fedsim import FederatedSession as JaxSession  # noqa: E402
from repro.fedsim import LocalSpec as JaxLocal  # noqa: E402
from repro.fedsim import TrainSpec as JaxTrain  # noqa: E402
from repro.fedsim import faults as jfaults  # noqa: E402
from repro.fedsim import local as jlocal  # noqa: E402
from repro.fedsim.specs import FaultSpec as JaxFault  # noqa: E402
from repro.fedsim.specs import LOCAL_TRAIN_TAG as JAX_LOCAL_TRAIN_TAG  # noqa: E402
from repro_torch.core.algorithm import round_generator  # noqa: E402
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.fedsim import (  # noqa: E402
    CohortSpec,
    FaultSpec,
    FederatedSession,
    LocalSpec,
    TrainSpec,
    build_cohort_local_fn,
    cohort_updates,
    cohort_updates_spec,
    local_update_spec,
)
from repro_torch.fedsim import faults as tfaults  # noqa: E402
from repro_torch.fedsim.local import local_shuffles  # noqa: E402
from repro_torch.fedsim.server import local_caller  # noqa: E402
from repro_torch.fedsim.specs import LOCAL_TRAIN_TAG  # noqa: E402

M, N, D, TAU, ETA_L, ROUNDS = 16, 12, 6, 3, 0.3, 4
# full batch: prox, momentum, both; minibatch: b | n, a remainder (12 = 2 x 5
# + 2 dropped), b > n (one step on all n), with prox and momentum on top
FULL = [dict(prox_mu=0.1), dict(momentum=0.7), dict(prox_mu=0.05, momentum=0.9)]
MINI = [dict(batch_size=3), dict(batch_size=5, epochs=2), dict(batch_size=20),
        dict(batch_size=4, epochs=2, prox_mu=0.01, momentum=0.9)]


def spec_id(kw):
    return ",".join(f"{k}={v}" for k, v in kw.items())


@pytest.fixture(scope="module")
def targets():
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (M, N, D)), np.float32)


def jax_loss(w, b):
    return 0.5 * jnp.mean(jnp.sum(jnp.square(w - b), -1))


def loss(w, b):
    return 0.5 * torch.mean(torch.sum(torch.square(w - b), -1))


def close_vec(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def jax_perms(key, epochs, n):
    """JAX's (epochs, n) shuffles of one client key (``local_update_spec``)."""
    return jax.vmap(lambda e: jax.random.permutation(jax.random.fold_in(key, e), n))(
        jnp.arange(epochs, dtype=jnp.int32))


def jax_block_perms(round_key, m, epochs, n, start=0):
    """(m, epochs, n): JAX's shuffles of a block of m clients at ``start``
    (``cohort_updates_spec``: client i's key folds its global index)."""
    base = jax.random.fold_in(round_key, JAX_LOCAL_TRAIN_TAG)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(start, start + m))
    return torch.tensor(np.asarray(jax.vmap(lambda k: jax_perms(k, epochs, n))(keys)),
                        dtype=torch.int64)


def test_the_tag_is_jaxs():
    assert LOCAL_TRAIN_TAG == JAX_LOCAL_TRAIN_TAG == 2**31 - 2


@pytest.mark.parametrize("kw", FULL + MINI, ids=spec_id)
def test_local_update_spec_equals_jax(kw, targets):
    """One client, weights away from 0; a minibatch spec on JAX's shuffles."""
    w0 = 0.2 * np.arange(D, dtype=np.float32)
    key = jax.random.PRNGKey(5)
    want = jlocal.local_update_spec(jax_loss, jnp.asarray(w0), jnp.asarray(targets[0]), key,
                                    JaxLocal(**kw), TAU, ETA_L)
    perms = torch.tensor(np.asarray(jax_perms(key, kw.get("epochs", 1), N)), dtype=torch.int64)
    got = local_update_spec(loss, torch.tensor(w0), torch.tensor(targets[0]),
                            perms if "batch_size" in kw else None, LocalSpec(**kw), TAU, ETA_L)
    close_vec(got, want)


@pytest.mark.parametrize("kw", FULL + MINI, ids=spec_id)
@pytest.mark.parametrize("cut", [False, True], ids=["all-steps", "steps"])
def test_cohort_updates_spec_equals_jax(kw, cut, targets):
    """The cohort, vmapped; with ``steps=`` every client's own cutoff (0 to
    past the last step)."""
    w = 0.1 * np.ones(D, np.float32)
    key = jax.random.PRNGKey(11)
    steps = np.arange(M, dtype=np.int32) % 5 if cut else None
    want = jlocal.cohort_updates_spec(jax_loss, jnp.asarray(w), jnp.asarray(targets),
                                      JaxLocal(**kw), TAU, ETA_L, key,
                                      steps=None if steps is None else jnp.asarray(steps))
    got = cohort_updates_spec(loss, torch.tensor(w), torch.tensor(targets), LocalSpec(**kw), TAU,
                              ETA_L, steps=None if steps is None else torch.tensor(steps),
                              perms=jax_block_perms(key, M, kw.get("epochs", 1), N))
    close_vec(got, want)


def test_a_gathered_block_on_jaxs_shuffles_equals_jax(targets):
    """A block at a contiguous offset, as JAX keys it (global index start + i)."""
    kw = dict(batch_size=4, epochs=2, momentum=0.5)
    key = jax.random.PRNGKey(2)
    w = 0.1 * np.ones(D, np.float32)
    want = jlocal.cohort_updates_spec(jax_loss, jnp.asarray(w), jnp.asarray(targets[6:12]),
                                      JaxLocal(**kw), TAU, ETA_L, key, start=6)
    got = cohort_updates_spec(loss, torch.tensor(w), torch.tensor(targets[6:12]),
                              LocalSpec(**kw), TAU, ETA_L,
                              perms=jax_block_perms(key, 6, 2, N, start=6))
    close_vec(got, want)


def test_the_spec_trainer_trains_a_parameter_tree(targets):
    """Tree params: the update is a tree, equal to the flat trainer's through
    the flatten (JAX's test_pytree_native)."""
    from repro_torch.fedsim import flatten_model

    def tree_loss(p, b):
        return 0.5 * torch.mean(torch.sum(torch.square(p["a"] + p["b"] - b), -1))

    params = {"a": torch.zeros(D), "b": torch.ones(D)}
    spec = LocalSpec(batch_size=4, epochs=2, momentum=0.5)
    perms = local_shuffles(3, torch.arange(1), 2, N)[0]
    delta = local_update_spec(tree_loss, params, torch.tensor(targets[0]), perms, spec, 1, 0.2)
    assert set(delta) == {"a", "b"}
    flat, unravel = flatten_model(params)
    d_flat = local_update_spec(lambda wf, b: tree_loss(unravel(wf), b), flat,
                               torch.tensor(targets[0]), perms, spec, 1, 0.2)
    close_vec(flatten_model(delta)[0], d_flat)


def test_the_default_spec_is_cohort_updates_bit_for_bit(targets):
    w, t = 0.1 * torch.ones(D), torch.tensor(targets)
    want = cohort_updates(loss, w, t, TAU, ETA_L)
    for spec in (None, LocalSpec()):
        local_fn = build_cohort_local_fn(loss, spec, TAU)
        assert not getattr(local_fn, "uses_round_seed", False)
        assert torch.equal(local_fn(w, t, ETA_L), want)
    steps = torch.arange(M) % 3
    assert torch.equal(build_cohort_local_fn(loss, LocalSpec(), TAU)(w, t, ETA_L, steps=steps),
                       cohort_updates(loss, w, t, TAU, ETA_L, steps=steps))


def test_a_full_cover_minibatch_step_is_one_gd_step(targets):
    """batch_size = n, one epoch: one step on a permutation of all n samples,
    which only reorders the mean (JAX's tests/test_local.py:71)."""
    w0 = torch.zeros(D)
    perms = local_shuffles(1, torch.arange(1), 1, N)[0]
    got = local_update_spec(loss, w0, torch.tensor(targets[0]), perms,
                            LocalSpec(batch_size=N), tau=5, eta_l=0.3)
    g = torch.func.grad(loss)(w0, torch.tensor(targets[0]))
    close_vec(got, -0.3 * g)


def test_momentum_follows_its_recurrence(targets):
    """Two full-batch momentum steps, by hand (JAX's test_momentum_recurrence)."""
    w0, b = 0.3 * torch.ones(D), torch.tensor(targets[0])
    beta, eta = 0.7, 0.1
    got = local_update_spec(loss, w0, b, None, LocalSpec(momentum=beta), 2, eta)
    g1 = torch.func.grad(loss)(w0, b)
    w1 = w0 - eta * g1
    w2 = w1 - eta * (beta * g1 + torch.func.grad(loss)(w1, b))
    close_vec(got, w2 - w0)


# -- the port's own shuffles --------------------------------------------------


def test_shuffles_are_permutations_and_deterministic():
    p = local_shuffles(123, torch.arange(50), 3, N)
    assert p.shape == (50, 3, N) and p.dtype == torch.int64
    assert torch.equal(torch.sort(p, dim=-1).values, torch.arange(N).expand(50, 3, N))
    assert torch.equal(p, local_shuffles(123, torch.arange(50), 3, N))


def test_shuffles_differ_across_rounds_clients_and_epochs():
    seeds = [round_generator(0, t).initial_seed() for t in range(2)]
    a, b = (local_shuffles(s, torch.arange(40), 2, N) for s in seeds)
    assert (a != b).any(dim=-1).float().mean() > 0.9          # rounds
    assert len({tuple(r.tolist()) for r in a[:, 0]}) == 40    # clients
    assert (a[:, 0] != a[:, 1]).any(dim=-1).all()             # epochs


def test_a_clients_shuffle_depends_on_its_global_index_alone():
    """A gathered block (host slot tensor) and any split into contiguous
    blocks shuffle each client as the dense cohort does, in bits."""
    seed = round_generator(3, 1).initial_seed()
    dense = local_shuffles(seed, torch.arange(M), 2, N)
    slots = torch.tensor([2, 3, 7, 11, 0, 0])
    assert torch.equal(local_shuffles(seed, slots, 2, N), dense[slots])
    halves = [local_shuffles(seed, torch.arange(s, s + M // 2), 2, N) for s in (0, M // 2)]
    assert torch.equal(torch.cat(halves), dense)


def test_the_trainers_gathered_block_equals_its_dense_rows(targets):
    """``cohort_updates_spec`` keyed by the round's seed: a gathered block
    (host slots) and two contiguous halves give the dense rows in bits."""
    spec = LocalSpec(batch_size=4, epochs=2, prox_mu=0.01, momentum=0.9)
    w, t, seed = 0.1 * torch.ones(D), torch.tensor(targets), 99
    dense = cohort_updates_spec(loss, w, t, spec, TAU, ETA_L, seed)
    slots = torch.tensor([1, 4, 5, 13])
    block = cohort_updates_spec(loss, w, t[slots], spec, TAU, ETA_L, seed, start=slots)
    assert torch.equal(block, dense[slots])
    half = cohort_updates_spec(loss, w, t[8:], spec, TAU, ETA_L, seed, start=8)
    assert torch.equal(half, dense[8:])
    other = cohort_updates_spec(loss, w, t, spec, TAU, ETA_L, seed + 1)
    assert not torch.equal(other, dense)


def test_a_minibatch_trainer_needs_the_rounds_seed(targets):
    with pytest.raises(ValueError, match="round_seed"):
        cohort_updates_spec(loss, torch.zeros(D), torch.tensor(targets), LocalSpec(batch_size=4),
                            TAU, ETA_L)
    with pytest.raises(ValueError, match="per-sample axis"):
        local_update_spec(loss, torch.zeros(D), {"x": torch.tensor(1.0)},
                          torch.zeros(1, 1, dtype=torch.int64), LocalSpec(batch_size=4), 1, 0.1)


# -- sessions -----------------------------------------------------------------


def jax_session(name, targets, kw, rounds=ROUNDS):
    return JaxSession(jax_make(name), jax_loss, jnp.zeros(D), jnp.asarray(targets),
                      train=JaxTrain(rounds=rounds, tau=TAU, eta_l=ETA_L),
                      local=JaxLocal(**kw))


def session(targets, kw, name="cdp-fedexp", rounds=ROUNDS, **extra):
    alg = make_algorithm(name, **({} if name in ("fedavg", "fedexp") else dict(
        clip_norm=0.5, sigma=0.05, num_clients=M)))
    return FederatedSession(alg, loss, np.zeros(D, np.float32), targets,
                            train=TrainSpec(rounds=rounds, tau=TAU, eta_l=ETA_L),
                            local=LocalSpec(**kw), device="cpu", **extra)


@pytest.mark.parametrize("kw", FULL, ids=spec_id)
@pytest.mark.parametrize("name", ["fedavg", "fedexp"])
def test_noiseless_prox_and_momentum_sessions_equal_jax(name, kw, targets):
    """Full-batch spec trainers draw nothing: the runs are deterministic."""
    want = jax_session(name, targets, kw).run(jax.random.PRNGKey(0))
    got = session(targets, kw, name).run(0)
    np.testing.assert_allclose(got.eta_history.numpy(), np.asarray(want.eta_history),
                               rtol=1e-5)
    close_vec(got.final_w, want.final_w)


def fields(r):
    return (r.final_w, r.last_w, r.eta_history, r.metric_history, r.eta_naive_history,
            r.eta_target_history)


def same_bits(x, y):
    """Equal tensors, NaN where both are NaN."""
    return x.shape == y.shape and bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


def same_run(a, b):
    return all(same_bits(x, y) for x, y in zip(fields(a), fields(b)))


MINI_SESSION = dict(batch_size=4, epochs=2, prox_mu=0.01, momentum=0.9)


def test_a_minibatch_run_is_deterministic_and_seeded(targets):
    a, b = session(targets, MINI_SESSION).run(0), session(targets, MINI_SESSION).run(0)
    assert same_run(a, b) and torch.isfinite(a.final_w).all()
    assert not torch.equal(session(targets, MINI_SESSION).run(1).final_w, a.final_w)


def test_a_minibatch_run_resumes_bit_for_bit(targets, tmp_path):
    want = session(targets, MINI_SESSION).run(5)
    assert same_run(session(targets, MINI_SESSION).run(5, checkpoint_dir=str(tmp_path),
                                                       checkpoint_every=2), want)
    os.remove(tmp_path / f"ckpt_{ROUNDS:08d}.npz")
    assert same_run(session(targets, MINI_SESSION).resume(str(tmp_path)), want)


def test_a_minibatch_sweep_equals_its_runs(targets):
    """``run_batched`` over seeds, also with a per-seed model and data."""
    s = session(targets, MINI_SESSION)
    sweep = s.run_batched([0, 3])
    for i, seed in enumerate((0, 3)):
        assert all(same_bits(x[i], y) for x, y in zip(fields(sweep), fields(s.run(seed))))
    w0s = np.stack([np.zeros(D, np.float32), 0.1 * np.ones(D, np.float32)])
    data = np.stack([targets, targets[::-1].copy()])
    stacked = FederatedSession(make_algorithm("fedexp"), loss, w0s, data,
                               train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                               local=LocalSpec(**MINI_SESSION), num_clients=M, device="cpu")
    sweep = stacked.run_batched([0, 1], batched_w0=True, batched_data=True)
    for i in range(2):
        one = FederatedSession(make_algorithm("fedexp"), loss, w0s[i], data[i],
                               train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                               local=LocalSpec(**MINI_SESSION), device="cpu").run(i)
        assert all(same_bits(x[i], y) for x, y in zip(fields(sweep), fields(one)))


@pytest.mark.parametrize("name", ["fedavg", "cdp-fedexp"])
def test_gathered_minibatch_rounds_equal_dense_ones(name, targets):
    """q = 0.5: the gathered block trains its clients on the dense round's
    shuffles; the whole runs agree at rtol 1e-5 (sums in other orders)."""
    dense = session(targets, MINI_SESSION, name, cohort=CohortSpec(q=0.5)).run(2)
    gathered = session(targets, MINI_SESSION, name,
                       cohort=CohortSpec(q=0.5, gather=True)).run(2)
    close_vec(gathered.final_w, dense.final_w)
    np.testing.assert_allclose(gathered.eta_history.numpy(), dense.eta_history.numpy(),
                               rtol=1e-5)


FAULT = dict(dropout=0.3, straggler=0.2, straggler_steps=1, corrupt=0.02)


@pytest.mark.parametrize("cohort", [None, dict(q=0.5, gather=True)])
def test_faulted_minibatch_runs_are_reproducible(cohort, targets):
    kw = dict(fault=FaultSpec(**FAULT), cohort=None if cohort is None else CohortSpec(**cohort))
    a = session(targets, MINI_SESSION, **kw).run(7)
    assert same_run(a, session(targets, MINI_SESSION, **kw).run(7))
    assert torch.isfinite(a.final_w).all()
    clean = session(targets, MINI_SESSION,
                    cohort=None if cohort is None else CohortSpec(**cohort)).run(7)
    assert not torch.equal(clean.final_w, a.final_w)


def test_under_a_fault_model_every_client_stops_at_tau(targets):
    """JAX resolves the straggler cutoff against TrainSpec.tau for every
    trainer, so a minibatch client with epochs x (n // b) = 6 > tau = 3 steps
    stops at step 3 under a fault model even when it does not straggle; the
    port does the same (ROADMAP queue 3)."""
    spec = LocalSpec(batch_size=4, epochs=2)
    fault = FaultSpec(straggler=0.2, straggler_steps=1)
    jsteps = np.asarray(jfaults.resolve_steps(JaxFault(straggler=0.2, straggler_steps=1),
                                              jnp.zeros(M), TAU))
    tsteps = tfaults.resolve_steps(fault, torch.zeros(M), TAU)
    assert (jsteps == TAU).all() and (tsteps.numpy() == TAU).all()
    w, t, seed = 0.1 * torch.ones(D), torch.tensor(targets), 17
    call = local_caller(build_cohort_local_fn(loss, spec, TAU), make_algorithm("fedavg"),
                        fault, TAU)
    got = call(w, t, ETA_L, 0, None, torch.zeros(M), seed)
    cut = cohort_updates_spec(loss, w, t, spec, TAU, ETA_L, seed,
                              steps=torch.full((M,), TAU))
    uncut = cohort_updates_spec(loss, w, t, spec, TAU, ETA_L, seed)
    assert torch.equal(got, cut) and not torch.allclose(got, uncut)
    # JAX's trainer, on its own shuffles, cut at tau: the same three steps
    key = jax.random.PRNGKey(4)
    jcut = jlocal.cohort_updates_spec(jax_loss, jnp.asarray(w.numpy()), jnp.asarray(targets),
                                      JaxLocal(batch_size=4, epochs=2), TAU, ETA_L, key,
                                      steps=jnp.asarray(jsteps))
    perms = jax_block_perms(key, M, 2, N)
    close_vec(cohort_updates_spec(loss, w, t, spec, TAU, ETA_L, perms=perms,
                                  steps=torch.full((M,), TAU)), jcut)
    close_vec(cohort_updates_spec(loss, w, t, LocalSpec(batch_size=4), TAU, ETA_L,
                                  perms=perms[:, :1]), jcut)
