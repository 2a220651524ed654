"""The port's generated image set and label-Dirichlet split against the JAX
package's, on the CPU.

``dirichlet_partition`` draws from numpy's ``default_rng(seed)`` in both
packages, so the indices and masks are held equal exactly.  The image
arithmetic (``smooth_random_field``, ``image_split``) is fed the JAX
package's own draws (the Fourier coefficients, labels, shifts, gains and
pixel noise, split off each key as ``make_image_dataset`` splits it) and held
to its images at atol 1e-5 (float32 inverse FFTs in other orders, on values
in [0, 1]).  ``client_image_batches`` gathers the same rows.  The port's own
draws come from a ``torch.Generator`` and are held to their documented
ranges.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.data.dirichlet import client_image_batches as jax_batches  # noqa: E402
from repro.data.dirichlet import dirichlet_partition as jax_partition  # noqa: E402
from repro.data.images import make_image_dataset as jax_images  # noqa: E402
from repro_torch.data import (  # noqa: E402
    ImageDataset,
    client_image_batches,
    dirichlet_partition,
    make_image_dataset,
)
from repro_torch.data.images import image_split, smooth_random_field  # noqa: E402

N_TRAIN, N_TEST = 400, 100


@pytest.fixture(scope="module")
def jax_set():
    return jax_images(jax.random.PRNGKey(7), num_train=N_TRAIN, num_test=N_TEST)


def jax_draws(key, num_train=N_TRAIN, num_test=N_TEST, shift_px=2):
    """The draws of JAX's ``make_image_dataset(key, ...)``, split as it splits
    its keys: Fourier coefficients, then each split's labels, shifts, pixel
    noise and gains."""
    k_tpl, k_tr, k_te = jax.random.split(key, 3)
    k_re, k_im = jax.random.split(k_tpl)
    coef = (np.asarray(jax.random.normal(k_re, (10, 6, 6)))
            + 1j * np.asarray(jax.random.normal(k_im, (10, 6, 6))))

    def split(k, n):
        k_lab, k_shift, k_noise, k_gain = jax.random.split(k, 4)
        return {"labels": torch.tensor(np.asarray(jax.random.randint(k_lab, (n,), 0, 10))),
                "shifts": torch.tensor(np.asarray(
                    jax.random.randint(k_shift, (n, 2), -shift_px, shift_px + 1))),
                "gain": torch.tensor(np.asarray(0.8 + 0.4 * jax.random.uniform(k_gain,
                                                                              (n, 1, 1)))),
                "pixel_noise": torch.tensor(np.asarray(jax.random.normal(k_noise,
                                                                         (n, 28, 28))))}

    return torch.tensor(coef.astype(np.complex64)), split(k_tr, num_train), split(k_te, num_test)


def test_the_image_arithmetic_on_jaxs_draws_equals_jax(jax_set):
    coef, train, test = jax_draws(jax.random.PRNGKey(7))
    templates = smooth_random_field(coef)
    for draws, (jx, jy) in ((train, (jax_set.train_x, jax_set.train_y)),
                            (test, (jax_set.test_x, jax_set.test_y))):
        x, y = image_split(templates, **draws)
        assert x.shape == jx.shape and x.dtype == torch.float32 and y.dtype == torch.int32
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-5)


def test_the_templates_equal_jaxs_smooth_field():
    """Each template spans [0, 1] exactly, as JAX normalises it."""
    from repro.data.images import _smooth_random_field
    key = jax.random.PRNGKey(3)
    want = np.asarray(_smooth_random_field(key, 10))
    k_re, k_im = jax.random.split(key)
    coef = torch.tensor((np.asarray(jax.random.normal(k_re, (10, 6, 6)))
                         + 1j * np.asarray(jax.random.normal(k_im, (10, 6, 6))))
                        .astype(np.complex64))
    got = smooth_random_field(coef)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.allclose(got.amin(dim=(1, 2)), torch.zeros(10))
    assert torch.allclose(got.amax(dim=(1, 2)), torch.ones(10))


@pytest.mark.parametrize("seed,clients,alpha,per_client", [
    (0, 8, 0.3, 16), (1, 25, 0.3, None), (5, 7, 0.05, 40), (2, 10, 10.0, 12)])
def test_the_dirichlet_split_equals_jaxs_exactly(seed, clients, alpha, per_client, jax_set):
    labels = np.asarray(jax_set.train_y)
    want = jax_partition(seed, labels, clients, alpha=alpha, samples_per_client=per_client)
    got = dirichlet_partition(seed, torch.tensor(labels), clients, alpha=alpha,
                              samples_per_client=per_client)
    assert got["idx"].dtype == torch.int32 and got["mask"].dtype == torch.float32
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    # numpy labels too
    again = dirichlet_partition(seed, labels, clients, alpha=alpha,
                                samples_per_client=per_client)
    assert torch.equal(again["idx"], got["idx"])


def test_client_image_batches_equal_jaxs(jax_set):
    labels = np.asarray(jax_set.train_y)
    part = dirichlet_partition(0, labels, 8, samples_per_client=16)
    want = jax_batches(jax_set, jax_partition(0, labels, 8, samples_per_client=16))
    tset = ImageDataset(train_x=torch.tensor(np.asarray(jax_set.train_x)),
                        train_y=torch.tensor(np.asarray(jax_set.train_y)),
                        test_x=torch.tensor(np.asarray(jax_set.test_x)),
                        test_y=torch.tensor(np.asarray(jax_set.test_y)))
    got = client_image_batches(tset, part)
    assert set(got) == set(want) == {"x", "y", "mask"}
    assert got["x"].shape == (8, 16, 28, 28, 1)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_the_label_skew_is_strong_at_alpha_0_3(jax_set):
    """Dir(0.3): most clients hold few classes (the paper's heterogeneity)."""
    labels = torch.tensor(np.asarray(jax_set.train_y))
    part = dirichlet_partition(4, labels, 40, samples_per_client=12)
    held = [len(torch.unique(labels[part["idx"][i].long()])) for i in range(40)]
    assert np.mean(held) < 5


def test_the_ports_own_draws_keep_their_ranges():
    ds = make_image_dataset(torch.Generator().manual_seed(7), num_train=N_TRAIN,
                            num_test=N_TEST)
    assert ds.train_x.shape == (N_TRAIN, 28, 28, 1) and ds.test_x.shape == (N_TEST, 28, 28, 1)
    assert ds.train_y.dtype == torch.int32 and ds.num_classes == 10
    assert float(ds.train_x.min()) >= 0.0 and float(ds.train_x.max()) <= 1.0
    assert set(ds.train_y.tolist()) == set(range(10))
    again = make_image_dataset(torch.Generator().manual_seed(7), num_train=N_TRAIN,
                               num_test=N_TEST)
    assert torch.equal(again.train_x, ds.train_x) and torch.equal(again.test_y, ds.test_y)
    other = make_image_dataset(torch.Generator().manual_seed(8), num_train=N_TRAIN,
                               num_test=N_TEST)
    assert not torch.equal(other.train_x, ds.train_x)
