"""The port's group-local MoE dispatch against the JAX package's, on the CPU.

The JAX oracle for G > 1: ``moe_apply`` under ``jax.jit`` on a 1 x 1 mesh
whose axes are ``AxisType.Auto`` (``jax.make_mesh``'s default Explicit axes
make ``with_sharding_constraint`` raise), installed by ``jax.set_mesh``, with
rules whose axis sizes say {"data": G, "model": 1} and "batch" on "data":
``group_count("batch")`` is then G while one device runs it.  The port gets
the same rules through ``models.sharding.axis_rules``.

Reduced granite-moe (4 experts, top-2, float32 combine) and reduced llama4
(top-1, the shared expert, the combine in the model dtype), float32, at G in
{1, 2, 4}, at a capacity factor of 0.5 so that each group drops its own
tokens (G = 2 must differ from G = 1), and at 4.0, where nothing drops and
every G gives the same output.  Float32 tolerance: rtol 1e-5 with an atol of
1e-5 times the largest entry (``tests/test_torch_moe.py``).  Also
``moe_group_dispatch=False`` and both fallbacks to one group (G not
dividing the batch; fewer tokens a group than experts), and G = 1 in the
bits of the dispatch before groups (``ungrouped_moe_apply`` below, the
port's ``moe_apply`` as it was).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.sharding import AXIS_SIZES_KEY as JAX_SIZES  # noqa: E402
from repro.models.sharding import axis_rules as jax_axis_rules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.mlp import activation  # noqa: E402
from repro_torch.models.sharding import AXIS_SIZES_KEY, axis_rules  # noqa: E402

GRANITE, LLAMA4 = "granite-moe-1b-a400m", "llama4-maverick-400b-a17b"
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread (a pool of them only contends)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(name, cf):
    jc = dataclasses.replace(jconfigs.reduced(jconfigs.ARCHS[name]), capacity_factor=cf)
    pc = dataclasses.replace(configs.reduced(configs.ARCHS[name]), capacity_factor=cf)
    return jc, pc


def inputs(pc, batch=4, seq=64, seed=0):
    rng = np.random.default_rng(seed)
    params = {n: (rng.standard_normal(p.shape) / np.sqrt(p.fan_in)).astype(np.float32)
              for n, p in moe.moe_defs(pc).items()}
    x = rng.standard_normal((batch, seq, pc.d_model)).astype(np.float32)
    return params, x


def rules_for(g, **extra):
    return {"batch": "data", "experts": "model", "ff": "model", **extra}


def jax_apply(jc, params, x, g, **extra):
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    rules = {JAX_SIZES: {"data": g, "model": 1}, **rules_for(g, **extra)}
    with jax.set_mesh(mesh), jax_axis_rules(rules):
        y, aux = jax.jit(lambda p, v: jax_moe.moe_apply(p, v, jc))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return np.asarray(y), float(aux)


def port_apply(pc, params, x, g, **extra):
    with axis_rules({AXIS_SIZES_KEY: {"data": g, "model": 1}, **rules_for(g, **extra)}):
        y, aux = moe.moe_apply({k: torch.tensor(v) for k, v in params.items()},
                               torch.tensor(x), pc)
    return y.numpy(), float(aux)


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("cf", [0.5, 4.0])
@pytest.mark.parametrize("name", [GRANITE, LLAMA4])
def test_grouped_matches_jax(name, cf, g):
    jc, pc = cfgs(name, cf)
    params, x = inputs(pc)
    assert moe.dispatch_groups(4, 4 * 64, pc.num_experts) == 1      # no rules: one group
    with axis_rules({AXIS_SIZES_KEY: {"data": g, "model": 1}, **rules_for(g)}):
        assert moe.dispatch_groups(4, 4 * 64, pc.num_experts) == g
    got, got_aux = port_apply(pc, params, x, g)
    want, want_aux = jax_apply(jc, params, x, g)
    close(got, want)
    assert got_aux == pytest.approx(want_aux, rel=RTOL)


@pytest.mark.parametrize("name", [GRANITE, LLAMA4])
def test_groups_drop_on_their_own(name):
    """At cf 0.5 the groups' capacities bind, so G = 2 and G = 4 differ from
    G = 1 (and from each other); at cf 4.0 no token drops and G changes
    nothing (float32 sums in other orders: rtol 1e-5)."""
    _, pc = cfgs(name, 0.5)
    params, x = inputs(pc)
    outs = [port_apply(pc, params, x, g)[0] for g in (1, 2, 4)]
    assert np.abs(outs[0] - outs[1]).max() > 1e-3
    assert np.abs(outs[1] - outs[2]).max() > 1e-3
    _, pc = cfgs(name, 4.0)
    outs = [port_apply(pc, params, x, g)[0] for g in (1, 2, 4)]
    close(outs[1], outs[0])
    close(outs[2], outs[0])


def test_dropped_share_per_group():
    _, pc = cfgs(GRANITE, 0.5)
    params, x = inputs(pc)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    base = moe.dropped_share(tp, torch.tensor(x), pc)
    with axis_rules({AXIS_SIZES_KEY: {"data": 4, "model": 1}, **rules_for(4)}):
        grouped = moe.dropped_share(tp, torch.tensor(x), pc)
    # each of the 4 groups: cap = max(4, ceil(int(0.5 * 64) / 4)) = 8 a slot
    _, _, _, pos = moe.route(tp, torch.tensor(x).reshape(-1, pc.d_model), pc, groups=4)
    assert grouped == pytest.approx(float((pos >= 8).float().mean()))
    _, _, _, pos = moe.route(tp, torch.tensor(x).reshape(-1, pc.d_model), pc)
    assert base == pytest.approx(float((pos >= moe.capacity(pc, 4 * 64)).float().mean()))


@pytest.mark.parametrize("name", [GRANITE, LLAMA4])
def test_group_dispatch_off_and_fallbacks(name):
    """``moe_group_dispatch=False`` (giant training), a G that does not divide
    the batch, and groups of fewer tokens than experts all dispatch one group:
    the bits of no rules, and JAX's output."""
    jc, pc = cfgs(name, 0.5)
    params, x = inputs(pc)
    none, _ = port_apply(pc, params, x, 1)
    off, _ = port_apply(pc, params, x, 4, moe_group_dispatch=False)
    np.testing.assert_array_equal(off, none)
    close(off, jax_apply(jc, params, x, 4, moe_group_dispatch=False)[0])

    p3, x3 = inputs(pc, batch=3, seed=1)                 # 3 % 2 != 0
    one3, _ = port_apply(pc, p3, x3, 1)
    np.testing.assert_array_equal(port_apply(pc, p3, x3, 2)[0], one3)
    close(port_apply(pc, p3, x3, 2)[0], jax_apply(jc, p3, x3, 2)[0])

    ps, xs = inputs(pc, batch=4, seq=1, seed=2)           # 4 tokens / 4 groups < 4 experts
    one_s, _ = port_apply(pc, ps, xs, 1)
    with axis_rules({AXIS_SIZES_KEY: {"data": 4, "model": 1}, **rules_for(4)}):
        assert moe.dispatch_groups(4, 4, pc.num_experts) == 1
    np.testing.assert_array_equal(port_apply(pc, ps, xs, 4)[0], one_s)
    close(port_apply(pc, ps, xs, 4)[0], jax_apply(jc, ps, xs, 4)[0])


def ungrouped_moe_apply(params, x, cfg, prefix="moe_"):
    """The port's ``moe_apply`` before the grouped dispatch: one group of
    all B*S tokens, its positions counted over all of them."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    t = b * s
    cap = moe.capacity(cfg, t)
    xf = x.reshape(t, d)
    logits = (xf @ params[prefix + "router"]).float()
    probs = torch.softmax(logits, dim=-1)
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = ranked.values[:, :k], ranked.indices[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    ids = gate_idx.T.contiguous()
    experts = torch.arange(e, device=xf.device)
    counts = torch.cumsum((ids[:, None, :] == experts[None, :, None]).to(torch.int32), dim=-1,
                          dtype=torch.int32)
    pos = torch.gather(counts, 1, ids[:, None, :])[:, 0].T - 1
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux_loss = e * torch.sum(me * ce)
    acc_dtype = x.dtype if k == 1 else torch.float32
    y = torch.zeros((t, d), dtype=acc_dtype, device=x.device)
    sentinel = xf.new_zeros((1, d))
    for slot in range(k):
        keep = pos[:, slot] < cap
        slot_idx = torch.where(keep, gate_idx[:, slot] * cap + pos[:, slot], e * cap)
        buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=x.device)
        buf = buf.index_copy(0, slot_idx, xf)[: e * cap].reshape(e, cap, d)
        h = activation(cfg, torch.bmm(buf, params[prefix + "wi"]))
        out = torch.bmm(h, params[prefix + "wo"])
        out_flat = torch.cat([out.reshape(e * cap, d), sentinel.to(out.dtype)]).to(x.dtype)
        gathered = out_flat.index_select(0, slot_idx)
        weight = (gate_vals[:, slot] * keep).to(acc_dtype)
        y = y + gathered.to(acc_dtype) * weight[:, None]
    if cfg.moe_shared_expert:
        h = activation(cfg, xf @ params[prefix + "shared_wi"])
        y = y + (h @ params[prefix + "shared_wo"]).to(acc_dtype)
    return y.reshape(b, s, d).to(x.dtype), aux_loss


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("name", [GRANITE, LLAMA4])
def test_one_group_keeps_the_bits(name, cf, dtype):
    """Without rules (G = 1) the output, the aux loss and the gradients are
    those of the ungrouped dispatch, bit for bit."""
    _, pc = cfgs(name, cf)
    params, x = inputs(pc, seed=3)
    tp = {k: torch.tensor(v).to(dtype).requires_grad_() for k, v in params.items()}
    tx = torch.tensor(x).to(dtype).requires_grad_()
    got, got_aux = moe.moe_apply(tp, tx, pc)
    grads = torch.autograd.grad(got.float().sum() + got_aux, [tx, *tp.values()])
    want, want_aux = ungrouped_moe_apply(tp, tx, pc)
    wgrads = torch.autograd.grad(want.float().sum() + want_aux, [tx, *tp.values()])
    assert torch.equal(got, want) and torch.equal(got_aux, want_aux)
    for a, b in zip(grads, wgrads):
        assert torch.equal(a, b)


def test_grouped_gradients_flow():
    """Under G = 2 the router, the experts and x all get finite gradients."""
    _, pc = cfgs(GRANITE, 0.5)
    params, x = inputs(pc, seed=4)
    tp = {k: torch.tensor(v).requires_grad_() for k, v in params.items()}
    tx = torch.tensor(x).requires_grad_()
    with axis_rules({AXIS_SIZES_KEY: {"data": 2, "model": 1}, **rules_for(2)}):
        y, aux = moe.moe_apply(tp, tx, pc)
    grads = torch.autograd.grad(y.sum() + aux, [tx, *tp.values()])
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
