"""The port's checkpoints against the JAX package's, on the CPU.

``repro_torch.checkpoint``: a round trip of every kind of node (dicts,
tuples, lists, NamedTuples, dataclasses, None) keeping dtypes; files the
port writes load through ``repro.checkpoint.load_checkpoint`` and files JAX
writes load through the port's, the server states (``AdaptiveClipState``,
``ScaffoldState``, Adam's moments) keyed alike; both packages reject the
same truncated, garbage, mangled and sha-mismatched files with a
``ValueError``; the newest intact checkpoint past corrupt ones; transient
``OSError`` retried with backoff and corruption never.  ``FederatedSession``:
a run resumed from a checkpoint equals the uninterrupted run in bits, for
the names whose server state differs in kind, under faults and under a
sampled cohort; a corrupt newest checkpoint is skipped; and the session's
refusals.
"""
import collections
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.core.adaptive_clip import AdaptiveClipState as JaxClipState  # noqa: E402
from repro.core.variance_reduction import ScaffoldState as JaxScaffoldState  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.core.adaptive_clip import AdaptiveClipState  # noqa: E402
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.core.variance_reduction import ScaffoldState  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    distance_to_opt,
    linreg_loss,
    make_synthetic_linreg,
)
from repro_torch.fedsim import CohortSpec, FederatedSession, LocalSpec, TrainSpec  # noqa: E402
from test_torch_faults import FAULT, assert_same_run, kwargs  # noqa: E402

M, D, TAU, ETA_L, ROUNDS = 44, 24, 3, 0.1, 6
Pair = collections.namedtuple("Pair", "a b")


@dataclasses.dataclass
class Holder:
    x: torch.Tensor
    y: tuple


@pytest.fixture(scope="module")
def data():
    d = make_synthetic_linreg(torch.Generator().manual_seed(3), M, D)
    return {k: getattr(d, k).numpy() for k in ("x", "y", "w_star")}


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(5, generator=g),
            "state": (AdaptiveClipState(clip=torch.tensor(0.7)),
                      Pair(torch.arange(3, dtype=torch.int32), torch.randn(2, 2, generator=g)),
                      None, [torch.tensor(2.5, dtype=torch.float64)]),
            "holder": Holder(x=torch.randn(4, generator=g), y=(torch.ones(1),)),
            "empty": ()}


def _equal_trees(a, b):
    ka, kb = ckpt._leaves_with_path(a), ckpt._leaves_with_path(b)
    assert [k for k, _ in ka] == [k for k, _ in kb]
    for (k, x), (_, y) in zip(ka, kb):
        assert type(x) is type(y), k
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_round_trip_keeps_structure_dtypes_and_paths(tmp_path):
    tree = _tree()
    path = ckpt.save_checkpoint(str(tmp_path), 7, tree, extra={"seed": 3})
    assert os.path.basename(path) == "ckpt_00000007.npz"
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000007.json", "ckpt_00000007.npz"]
    got, meta = ckpt.load_checkpoint(str(tmp_path), _tree(1))
    assert meta["step"] == 7 and meta["seed"] == 3 and len(meta["npz_sha256"]) == 64
    _equal_trees(got, tree)
    assert isinstance(got["state"][0], AdaptiveClipState) and isinstance(got["state"][1], Pair)
    assert got["state"][2] is None and isinstance(got["holder"], Holder)
    assert sorted(np.load(path).files) == [
        "holder/x", "holder/y/0", "state/0/clip", "state/1/a", "state/1/b", "state/3/0", "w"]


def test_a_port_file_loads_through_jax_and_a_jax_file_through_the_port(tmp_path):
    """The session's state types and an optimizer's tuple, written by one
    package and read by the other."""
    rng = np.random.default_rng(0)
    w, c, c_is = (rng.standard_normal(s).astype(np.float32) for s in ((D,), (D,), (M, D)))
    t_tree = {"carry": (torch.tensor(w), ScaffoldState(c=torch.tensor(c),
                                                       c_is=torch.tensor(c_is)),
                        AdaptiveClipState(clip=torch.tensor(0.25)),
                        (torch.tensor(w), torch.tensor(c), torch.tensor(3, dtype=torch.int32))),
              "hist": (torch.tensor(w[:4]),)}
    j_tree = {"carry": (jnp.asarray(w), JaxScaffoldState(c=jnp.asarray(c),
                                                         c_is=jnp.asarray(c_is)),
                        JaxClipState(clip=jnp.float32(0.25)),
                        (jnp.asarray(w), jnp.asarray(c), jnp.int32(3))),
              "hist": (jnp.asarray(w[:4]),)}
    ckpt.save_checkpoint(str(tmp_path / "port"), 2, t_tree, extra={"seed": 1})
    got, meta = jckpt.load_checkpoint(str(tmp_path / "port"),
                                      jax.tree_util.tree_map(jnp.zeros_like, j_tree))
    assert meta["seed"] == 1
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(j_tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, j_tree)
    back, _ = ckpt.load_checkpoint(str(tmp_path / "jax"), _zeros_like(t_tree))
    _equal_trees(back, t_tree)
    assert isinstance(back["carry"][1], ScaffoldState)


def _zeros_like(tree):
    return ckpt._rebuild(tree, iter(torch.zeros_like(x) for _, x in ckpt._leaves_with_path(tree)))


def _corrupt(directory, kind):
    path = os.path.join(directory, "ckpt_00000001.npz")
    if kind == "truncated":
        blob = open(path, "rb").read()[:20]
        open(path, "wb").write(blob)
    elif kind == "garbage":
        open(path, "wb").write(b"not a zip archive")
    elif kind == "sidecar":
        open(path[:-4] + ".json", "w").write("{not json")
    else:     # one byte flipped inside a valid archive: only the sha256 sees it
        blob = bytearray(open(path, "rb").read())
        blob[-1] ^= 0xFF
        open(path, "wb").write(bytes(blob))


MATCH = {"truncated": "corrupt checkpoint", "garbage": "corrupt checkpoint",
         "sidecar": "sidecar", "sha": "sha256 mismatch"}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", list(MATCH))
def test_both_packages_reject_the_same_corrupt_files(kind, writer, tmp_path):
    if writer == "port":
        ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(4)})
    else:
        jckpt.save_checkpoint(str(tmp_path), 1, {"w": jnp.zeros(4)})
    _corrupt(str(tmp_path), kind)
    with pytest.raises(ValueError, match=MATCH[kind]):
        ckpt.load_checkpoint(str(tmp_path), {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match=MATCH[kind]):
        jckpt.load_checkpoint(str(tmp_path), {"w": jnp.zeros(4)})


def _save(d, step, value=0.0):
    ckpt.save_checkpoint(str(d), step, {"w": torch.full((4,), value)}, extra={"k": "v"})


def test_latest_intact_falls_back_past_corruption(tmp_path):
    _save(tmp_path, 2, 2.0)
    _save(tmp_path, 4, 4.0)
    (tmp_path / "ckpt_00000004.npz").write_bytes(b"garbage")
    step, params, meta = ckpt.load_latest_intact(str(tmp_path), lambda s: {"w": torch.zeros(4)})
    assert step == 2 and meta["step"] == 2 and torch.equal(params["w"], torch.full((4,), 2.0))
    assert ckpt.checkpoint_steps(str(tmp_path)) == [2, 4] and ckpt.latest_step(str(tmp_path)) == 4


def test_latest_intact_reports_every_failure_and_an_empty_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.load_latest_intact(str(tmp_path), {"w": torch.zeros(4)})
    assert ckpt.latest_step(str(tmp_path / "absent")) is None
    _save(tmp_path, 1)
    _save(tmp_path, 2)
    for f in os.listdir(tmp_path):
        if f.endswith(".npz"):
            (tmp_path / f).write_bytes(b"junk")
    with pytest.raises(ValueError, match="no intact checkpoint.*step 2.*step 1"):
        ckpt.load_latest_intact(str(tmp_path), {"w": torch.zeros(4)})


def test_a_shape_or_leaf_mismatch_is_a_value_error(tmp_path):
    _save(tmp_path, 1)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint(str(tmp_path), {"w": torch.zeros(5)})
    with pytest.raises(ValueError, match="missing leaf"):
        ckpt.load_checkpoint(str(tmp_path), {"v": torch.zeros(4)})


def test_transient_oserror_is_retried_with_backoff(tmp_path, monkeypatch):
    _save(tmp_path, 1, 1.0)
    attempts, real = [], ckpt._load_once

    def flaky(directory, template, step):
        attempts.append(step)
        if len(attempts) < 3:
            raise OSError("transient I/O blip")
        return real(directory, template, step)

    monkeypatch.setattr(ckpt, "_load_once", flaky)
    sleeps = []
    monkeypatch.setattr(ckpt.time, "sleep", sleeps.append)
    params, _ = ckpt.load_checkpoint(str(tmp_path), {"w": torch.zeros(4)}, retries=3, backoff=0.1)
    assert len(attempts) == 3 and sleeps == [pytest.approx(0.1), pytest.approx(0.2)]
    assert torch.equal(params["w"], torch.ones(4))


def test_corruption_is_never_retried(tmp_path, monkeypatch):
    _save(tmp_path, 1)
    (tmp_path / "ckpt_00000001.npz").write_bytes(b"junk")
    attempts, real = [], ckpt._load_once

    def counting(directory, template, step):
        attempts.append(step)
        return real(directory, template, step)

    monkeypatch.setattr(ckpt, "_load_once", counting)
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(str(tmp_path), {"w": torch.zeros(4)}, retries=5)
    assert attempts == [1]


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------

def session(data, name, fault=None, cohort=None, rounds=ROUNDS):
    return FederatedSession(make_algorithm(name, **kwargs(name)), linreg_loss,
                            np.zeros(D, np.float32), {"x": data["x"], "y": data["y"]},
                            train=TrainSpec(rounds=rounds, tau=TAU, eta_l=ETA_L),
                            local=LocalSpec(control_variates=True) if name == "dp-scaffold"
                            else None, fault=fault, cohort=cohort,
                            eval_fn=distance_to_opt(torch.tensor(data["w_star"])), device="cpu")


# server states of each kind: none, Adam's (m, v, t), the adaptive clip's,
# SCAFFOLD's variates, and a weighted algorithm's none
RESUMED = ["ldp-fedexp-gauss", "dp-fedadam-cdp", "cdp-fedexp-adaptive-clip", "dp-scaffold",
           "ldp-fedexp-perclient", "ldp-fedexp-schedule"]


@pytest.mark.parametrize("name", RESUMED)
def test_a_resumed_run_equals_the_uninterrupted_one_bit_for_bit(name, data, tmp_path):
    want = session(data, name).run(4)
    session(data, name, rounds=4).run(4, checkpoint_dir=str(tmp_path))
    assert ckpt.checkpoint_steps(str(tmp_path)) == [4]
    assert_same_run(session(data, name).resume(str(tmp_path)), want)
    assert ckpt.checkpoint_steps(str(tmp_path)) == [4, ROUNDS]


@pytest.mark.parametrize("cohort", [None, dict(q=0.5, gather=True)])
@pytest.mark.parametrize("name", ["cdp-fedexp", "dp-scaffold"])
def test_a_faulted_run_resumes_bit_for_bit(name, cohort, data, tmp_path):
    spec = None if cohort is None else CohortSpec(**cohort)
    want = session(data, name, fault=FAULT, cohort=spec).run(11)
    every = session(data, name, fault=FAULT, cohort=spec)
    assert_same_run(every.run(11, checkpoint_dir=str(tmp_path), checkpoint_every=2), want)
    assert ckpt.checkpoint_steps(str(tmp_path)) == [2, 4, 6]
    for f in ("ckpt_00000006.npz", "ckpt_00000004.npz"):
        os.remove(tmp_path / f)
    assert_same_run(session(data, name, fault=FAULT, cohort=spec).resume(str(tmp_path)), want)


def test_resume_skips_a_corrupt_newest_checkpoint(data, tmp_path):
    want = session(data, "cdp-fedexp").run(11, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    (tmp_path / "ckpt_00000006.npz").write_bytes(b"bit rot")
    assert_same_run(session(data, "cdp-fedexp").resume(str(tmp_path)), want)


def test_the_checkpoint_holds_the_run(data, tmp_path):
    session(data, "dp-scaffold", rounds=3).run(9, checkpoint_dir=str(tmp_path))
    meta = ckpt._read_meta(str(tmp_path / "ckpt_00000003.npz"))
    assert (meta["seed"], meta["algorithm"], meta["rounds_total"]) == (9, "dp-scaffold", 3)
    files = sorted(np.load(tmp_path / "ckpt_00000003.npz").files)
    assert files == ["carry/0", "carry/1/c", "carry/1/c_is", "carry/2", "hist/0", "hist/1",
                     "hist/2", "hist/3"]


def test_resume_refuses_a_foreign_or_later_checkpoint(data, tmp_path):
    session(data, "cdp-fedexp", rounds=4).run(0, checkpoint_dir=str(tmp_path / "a"))
    with pytest.raises(ValueError, match="algorithm 'cdp-fedexp'"):
        session(data, "dp-fedavg-cdp").resume(str(tmp_path / "a"))
    with pytest.raises(ValueError, match="past this session"):
        session(data, "cdp-fedexp", rounds=3).resume(str(tmp_path / "a"))
    with pytest.raises(FileNotFoundError):
        session(data, "cdp-fedexp").resume(str(tmp_path / "none"))
    done = session(data, "cdp-fedexp", rounds=4)
    assert_same_run(done.resume(str(tmp_path / "a")), done.run(0))
