"""params_from_jax and flatten_model against the JAX package's ravel_pytree."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fedsim.flat import flatten_model  # noqa: E402

rng = np.random.default_rng(0)
TREES = {
    "readme_W_b": {"W": rng.standard_normal((5, 3)), "b": rng.standard_normal(3)},
    "flat": rng.standard_normal(17),
    "nested": {"z": [rng.standard_normal((2, 2)), rng.standard_normal(4)],
               "a": {"k2": rng.standard_normal((3, 1, 2)), "k1": rng.standard_normal(1)}},
}


@pytest.mark.parametrize("which", list(TREES))
def test_flatten_order_matches_ravel_pytree(which):
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), TREES[which])
    want, _ = ravel_pytree(jtree)
    params = params_from_jax(jax.device_get(jtree), "cpu")
    got, unravel = flatten_model(params)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = unravel(got * 2)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(b), 2 * np.asarray(a)),
        jax.device_get(jtree),
        jax.tree_util.tree_map(lambda t: t.numpy(), back,
                               is_leaf=lambda t: isinstance(t, torch.Tensor)))


def test_params_from_jax_copies_read_only_leaves_and_keeps_dtype():
    tree = jax.device_get({"W": jnp.ones((2, 3), jnp.float32), "n": jnp.arange(4)})
    assert not tree["W"].flags.writeable
    out = params_from_jax(tree, "cpu")
    assert out["W"].dtype == torch.float32 and out["n"].dtype == torch.int32
    out["W"] += 1.0   # a writable copy: the JAX array is untouched
    assert float(tree["W"][0, 0]) == 1.0
    assert isinstance(params_from_jax(np.zeros(5, np.float32), "cpu"), torch.Tensor)


def test_params_from_jax_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("the missing-card error needs a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"W": np.zeros(2)}, "cuda")
