"""The port's CNNs (the paper's Table 3 models) against the JAX package's, on
the CPU.

Both variants on the JAX package's own initial weights, carried across by
``convert.params_from_jax``: the parameter count (d = 5046 CDP, 237 LDP) and
the flat order; the convolutions in NHWC; the forward logits; the
cross-entropy with and without a mask; its gradient, on the tree and on the
flat vector; the accuracy; the gradient under ``torch.func.vmap`` with
per-client weights (batched gathers and products) against a loop.  Float32 at
rtol 1e-5, atol 1e-6.  A 3-round noiseless session on the generated images
under a Dirichlet split against JAX's, FedAvg and FedEXP (eta_g up to ~7
here), full-batch GD and the spec trainer: its eta history at rtol 1e-5, the
final iterate at rtol 1e-5 with an atol of 1e-5 times its largest entry, the
test accuracy within one image of 100.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.data.dirichlet import client_image_batches as jax_batches  # noqa: E402
from repro.data.dirichlet import dirichlet_partition as jax_partition  # noqa: E402
from repro.data.images import make_image_dataset as jax_images  # noqa: E402
from repro.fedsim import FederatedSession as JaxSession  # noqa: E402
from repro.fedsim import LocalSpec as JaxLocal  # noqa: E402
from repro.fedsim import TrainSpec as JaxTrain  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.fedsim import FederatedSession, LocalSpec, TrainSpec, flatten_model  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

VARIANTS = {"cdp": 5046, "ldp": 237}
M, N, TAU, ROUNDS = 6, 16, 2, 3


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def images():
    ds = jax_images(jax.random.PRNGKey(7), num_train=400, num_test=100)
    return {k: np.asarray(getattr(ds, k)) for k in ("train_x", "train_y", "test_x", "test_y")}


def jax_params(variant, seed=100):
    """JAX's initial weights, with biases drawn as 0.1 |N(0, 1)| in place of
    zeros, so that a bias enters every sum (a non-negative bias keeps the
    ReLUs that JAX's init leaves alive alive)."""
    p = jcnn.make_cnn_params(jax.random.PRNGKey(seed), variant)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(p))
    return {k: v + 0.1 * jnp.abs(jax.random.normal(kk, v.shape)) if k.endswith("_b") else v
            for (k, v), kk in zip(sorted(p.items()), keys)}


def jax_model(variant):
    """JAX's flat ``CNNModel`` on ``jax_params``."""
    flat, unravel = ravel_pytree(jax_params(variant))
    return jcnn.CNNModel(init_flat=flat, unravel=unravel, dim=flat.shape[0])


def batch(images, n=N, masked=True):
    b = {"x": images["train_x"][:n], "y": images["train_y"][:n]}
    if masked:
        b["mask"] = (np.arange(n) % 3 != 0).astype(np.float32)
    return b


def tb(b):
    return {k: torch.tensor(v) for k, v in b.items()}


@pytest.mark.parametrize("variant", VARIANTS)
def test_the_parameters_keep_jaxs_names_shapes_and_flat_order(variant):
    jp = jcnn.make_cnn_params(jax.random.PRNGKey(100), variant)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    assert set(tp) == set(jp)
    fresh = cnn.make_cnn_params(torch.Generator().manual_seed(0), variant)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {k: v.shape for k, v in jp.items()}
    flat, _ = flatten_model(tp)
    assert flat.shape == (VARIANTS[variant],)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ravel_pytree(jp)[0]))
    model = cnn.make_cnn(torch.Generator().manual_seed(0), variant)
    assert model.dim == VARIANTS[variant] == jcnn.make_cnn(jax.random.PRNGKey(0), variant).dim


@pytest.mark.parametrize("variant", VARIANTS)
def test_he_init_has_the_stated_scale(variant):
    """He normal weights (std sqrt(2 / fan_in)), zero biases."""
    p = cnn.make_cnn_params(torch.Generator().manual_seed(1), variant)
    fan_in = {"c1_w": 16, "c2_w": 16 * p["c2_w"].shape[2], "f1_w": 128,
              "out_w": p["out_w"].shape[0]}
    for k, v in p.items():
        if k.endswith("_b"):
            assert not v.any()
        elif v.numel() >= 64:
            assert abs(float(v.std()) / (2.0 / fan_in[k]) ** 0.5 - 1.0) < 0.35, k


@pytest.mark.parametrize("variant", VARIANTS)
def test_the_convolutions_stay_nhwc(variant, images):
    """Each conv's output, NHWC from NHWC and HWIO (a patch gather and a
    product), equals JAX's ``conv_general_dilated``."""
    jp = jax_params(variant)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    x = images["train_x"][:5]
    h1 = jax.nn.relu(jcnn._conv(jnp.asarray(x), jp["c1_w"], jp["c1_b"], 2))
    h2 = jcnn._conv(h1, jp["c2_w"], jp["c2_b"], 3)
    t1 = torch.relu(cnn._conv(torch.tensor(x), tp["c1_w"], tp["c1_b"], 2))
    t2 = cnn._conv(t1, tp["c2_w"], tp["c2_b"], 3)
    assert t1.shape == h1.shape == (5, 13, 13, tp["c1_w"].shape[3])
    assert t2.shape == h2.shape == (5, 4, 4, tp["c2_w"].shape[3])
    close(t1, h1)
    close(t2, h2)


@pytest.mark.parametrize("variant", VARIANTS)
def test_the_flatten_is_in_nhwc_order(variant, images):
    """The FC rows meet the features in JAX's (NHWC) order: the forward
    equals JAX's, and a flatten in NCHW order (torch's habit) would not."""
    jp = jax_params(variant)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    x = torch.tensor(images["train_x"][:8])
    want = np.asarray(jcnn._forward(jp, jnp.asarray(images["train_x"][:8])))
    assert np.abs(want - want.mean(axis=0)).max() > 1e-3    # the logits depend on the image
    close(cnn._forward(tp, x), want)
    h = torch.relu(cnn._conv(torch.relu(cnn._conv(x, tp["c1_w"], tp["c1_b"], 2)),
                             tp["c2_w"], tp["c2_b"], 3))
    nchw = h.permute(0, 3, 1, 2).reshape(8, -1)
    if "f1_w" in tp:
        nchw = torch.relu(nchw @ tp["f1_w"] + tp["f1_b"])
    wrong = nchw @ tp["out_w"] + tp["out_b"]
    # the LDP CNN's c2 has one channel: there the two orders are one
    assert np.allclose(wrong.numpy(), want, rtol=1e-3, atol=1e-4) == (variant == "ldp")


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no-mask"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_loss_and_grad_equal_jax(variant, masked, images):
    jp = jax_params(variant)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    b = batch(images, masked=masked)
    jloss = jcnn.pytree_xent_loss()
    tloss = cnn.pytree_xent_loss()
    close(tloss(tp, tb(b)), jloss(jp, {k: jnp.asarray(v) for k, v in b.items()}))
    jg = jax.jit(jax.grad(jloss))(jp, {k: jnp.asarray(v) for k, v in b.items()})
    tg = torch.func.grad(tloss)(tp, tb(b))
    for k in jp:
        close(tg[k], jg[k], atol=1e-6)
    # the flat model: the same loss and gradient through the flatten
    jm = jax_model(variant)
    flat, unravel = flatten_model(tp)
    tm = cnn.CNNModel(init_flat=flat, unravel=unravel, dim=flat.shape[0])
    jfg = jax.jit(jax.grad(jcnn.masked_xent_loss(jm)))(
        jm.init_flat, {k: jnp.asarray(v) for k, v in b.items()})
    close(torch.func.grad(cnn.masked_xent_loss(tm))(flat, tb(b)), jfg)


@pytest.mark.parametrize("variant", VARIANTS)
def test_accuracy_equals_jax(variant, images):
    jm = jax_model(variant)
    flat, unravel = flatten_model(params_from_jax(jax.device_get(jax_params(variant)), "cpu"))
    tm = cnn.CNNModel(init_flat=flat, unravel=unravel, dim=flat.shape[0])
    x, y = images["test_x"], images["test_y"]
    want = float(jcnn.accuracy_fn(jm, jnp.asarray(x), jnp.asarray(y), chunk=30)(jm.init_flat))
    got = cnn.accuracy_fn(tm, torch.tensor(x), torch.tensor(y), chunk=30)(flat)
    assert got.dim() == 0 and float(got) == pytest.approx(want, abs=1e-7)
    tp = unravel(flat)
    assert float(cnn.pytree_accuracy_fn(torch.tensor(x), torch.tensor(y))(tp)) == \
        pytest.approx(float(jcnn.pytree_accuracy_fn(jnp.asarray(x), jnp.asarray(y))(
            jax_params(variant))), abs=1e-7)


@pytest.mark.parametrize("variant", VARIANTS)
def test_vmapped_grads_with_per_client_weights_equal_a_loop(variant, images):
    """After one local step every client holds its own weights: vmap(grad)
    over (weights, batch) pairs (batched gathers and products) equals the
    clients one by one."""
    model = cnn.make_cnn(torch.Generator().manual_seed(3), variant)
    loss = cnn.masked_xent_loss(model)
    ws = model.init_flat + 0.05 * torch.randn(4, model.dim, generator=torch.Generator()
                                              .manual_seed(4))
    bs = {k: torch.tensor(np.stack([batch(images)[k]] * 4)) for k in ("x", "y", "mask")}
    bs["x"] = bs["x"] * torch.linspace(0.7, 1.3, 4)[:, None, None, None, None]
    got = torch.func.vmap(torch.func.grad(loss))(ws, bs)
    for i in range(4):
        want = torch.func.grad(loss)(ws[i], {k: v[i] for k, v in bs.items()})
        close(got[i], want)


def problem(images, variant):
    part = jax_partition(0, images["train_y"], M, samples_per_client=N)
    ds = jax_images(jax.random.PRNGKey(7), num_train=400, num_test=100)
    jb = jax_batches(ds, part)
    return jb, {k: np.asarray(v) for k, v in jb.items()}


@pytest.mark.parametrize("local", [None, dict(momentum=0.5, prox_mu=0.01)], ids=["gd", "spec"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", ["fedavg", "fedexp"])
def test_a_noiseless_cnn_session_equals_jaxs(name, variant, local, images):
    rtol = 1e-5
    jb, tbatches = problem(images, variant)
    jm = jax_model(variant)
    x, y = images["test_x"], images["test_y"]
    want = JaxSession(jax_make(name), jcnn.masked_xent_loss(jm), jm.init_flat, jb,
                      train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=0.1),
                      local=None if local is None else JaxLocal(**local),
                      eval_fn=jcnn.accuracy_fn(jm, jnp.asarray(x), jnp.asarray(y))
                      ).run(jax.random.PRNGKey(0))
    flat, unravel = flatten_model(params_from_jax(jax.device_get(jax_params(variant)), "cpu"))
    tm = cnn.CNNModel(init_flat=flat, unravel=unravel, dim=flat.shape[0])
    got = FederatedSession(make_algorithm(name), cnn.masked_xent_loss(tm), flat, tbatches,
                           train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=0.1),
                           local=None if local is None else LocalSpec(**local),
                           eval_fn=cnn.accuracy_fn(tm, torch.tensor(x), torch.tensor(y)),
                           device="cpu").run(0)
    np.testing.assert_allclose(got.eta_history.numpy(), np.asarray(want.eta_history), rtol=rtol)
    want_w = np.asarray(want.final_w, np.float64)
    np.testing.assert_allclose(got.final_w.numpy(), want_w, rtol=rtol,
                               atol=rtol * np.abs(want_w).max())
    np.testing.assert_allclose(got.metric_history.numpy(), np.asarray(want.metric_history),
                               atol=1.5 / len(y))


def test_a_pytree_cnn_trains_by_minibatch_momentum(images):
    """e2's --quick leg at the test size: the parameter tree itself through
    the session, LocalSpec(batch_size=8, momentum=0.9); a tree comes back."""
    params = cnn.make_cnn_params(torch.Generator().manual_seed(100), "cdp")
    part = jax_partition(0, images["train_y"], M, samples_per_client=N)
    b = {"x": images["train_x"][np.asarray(part["idx"])],
         "y": images["train_y"][np.asarray(part["idx"])], "mask": np.asarray(part["mask"])}
    x, y = torch.tensor(images["test_x"]), torch.tensor(images["test_y"])
    alg = make_algorithm("cdp-fedexp", clip_norm=1.0, sigma=5.0 / M ** 0.5, num_clients=M)
    r = FederatedSession(alg, cnn.pytree_xent_loss(), params, b,
                         train=TrainSpec(rounds=ROUNDS, tau=1, eta_l=0.1),
                         local=LocalSpec(batch_size=8, epochs=1, momentum=0.9),
                         eval_fn=cnn.pytree_accuracy_fn(x, y), device="cpu").run(0)
    assert isinstance(r.final_w, dict) and r.final_w["c1_w"].shape == (4, 4, 1, 4)
    assert torch.isfinite(r.metric_history).all() and torch.isfinite(r.eta_history).all()
