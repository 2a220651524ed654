"""The port's round trackers against the JAX package's, on the CPU.

The same ``log`` / ``start_phase`` / ``sub`` / ``finish`` calls go to both
packages' sinks: ``JsonlTracker`` files must be equal byte for byte
(non-finite floats as null, nested containers scrubbed, keys sorted), and
``StdoutTracker`` must print the same lines.  ``WandbTracker`` raises
ImportError on construction where wandb is absent, in both packages.
"""
import importlib.util
import math

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import telemetry as jtel  # noqa: E402
from repro_torch import telemetry as ttel  # noqa: E402

EVENTS = [
    (0, {"loss": 2.5, "eta": 1.0, "update_norm": 0.75, "round_time_s": 0.125}),
    (1, {"loss": float("nan"), "eta": float("inf"), "note": "diverged"}),
    (2, {"event": "rollback", "to_round": 0, "nested": {"a": [1.0, float("-inf"), 3],
                                                         "b": (math.nan, "x")}}),
    (5, {"loss": 1.234567891, "count": 7, "flag": True, "none": None}),
    (7, {"loss": 0.5}),
]


def drive(pkg, tracker):
    tracker.start_phase("train", 0)
    for step, event in EVENTS:
        tracker.log(step, dict(event))
    child = tracker.sub(3)
    child.start_phase("replay", 1)
    child.log(4, {"loss": 0.25, "eta": float("nan")})
    child.finish()
    tracker.log(8, {"after_sub": 1})
    tracker.finish()


def test_jsonl_lines_equal_the_jax_packages(tmp_path):
    paths = {}
    for name, pkg in (("jax", jtel), ("torch", ttel)):
        paths[name] = tmp_path / name / "run.jsonl"
        drive(pkg, pkg.JsonlTracker(str(paths[name])))
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes()
    assert len(paths["torch"].read_text().splitlines()) == len(EVENTS) + 2


def test_jsonl_append_and_overwrite_as_the_jax_package(tmp_path):
    for append in (False, True):
        files = []
        for name, pkg in (("jax", jtel), ("torch", ttel)):
            path = tmp_path / f"{name}-{append}.jsonl"
            path.write_text('{"round": -1}\n')
            t = pkg.JsonlTracker(str(path), append=append)
            t.log(0, {"x": 1.0})
            files.append(path.read_bytes())
        assert files[0] == files[1]


@pytest.mark.parametrize("every", [1, 2, 5])
def test_stdout_lines_equal_the_jax_packages(capsys, every):
    out = {}
    for name, pkg in (("jax", jtel), ("torch", ttel)):
        drive(pkg, pkg.StdoutTracker(every=every, prefix="lm "))
        out[name] = capsys.readouterr().out
    assert out["torch"] == out["jax"]
    with pytest.raises(ValueError, match="every"):
        ttel.StdoutTracker(every=0)


def test_composite_fans_out_and_null_swallows(tmp_path, capsys):
    outs = {}
    for name, pkg in (("jax", jtel), ("torch", ttel)):
        path = tmp_path / f"{name}.jsonl"
        drive(pkg, pkg.CompositeTracker(pkg.NullTracker(), pkg.StdoutTracker(every=2),
                                        pkg.JsonlTracker(str(path))))
        outs[name] = (capsys.readouterr().out, path.read_bytes())
    assert outs["torch"] == outs["jax"]
    assert issubclass(ttel.NullTracker, ttel.Tracker)
    with pytest.raises(NotImplementedError):
        ttel.Tracker().log(0, {})


def test_wandb_is_import_gated():
    if importlib.util.find_spec("wandb") is not None:
        pytest.skip("wandb is installed here")
    for pkg in (jtel, ttel):
        with pytest.raises(ImportError):
            pkg.WandbTracker()
