"""The port stands alone: no file of src/repro_torch/, chip_smoke.py or
chip_compare.py imports jax or the JAX package ``repro``, and importing every
module of the port works with both blocked and without nvcc or a card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("chip_smoke.py", "chip_compare.py")
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / s for s in SCRIPTS]
BANNED = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "."   # relative imports could reach outside the package
            elif node.module:
                yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = sorted(set(_imported_roots(path)) & (BANNED | {"."}))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT_FILES if p.name not in SCRIPTS)
    code = ("import sys, importlib\n"
            "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke, chip_compare\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"},
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_scaffold_modules_stand_alone():
    """The control-variate slice's modules are among the files checked above
    and import neither jax nor the JAX package."""
    for rel in ("fedsim/scaffold.py", "core/variance_reduction.py"):
        path = ROOT / "src" / "repro_torch" / rel
        assert path in PORT_FILES
        assert not set(_imported_roots(path)) & (BANNED | {"."})


@pytest.mark.parametrize("rel", ["fedsim/faults.py", "checkpoint/__init__.py", "fedsim/specs.py",
                                 "fedsim/session.py", "fedsim/local.py", "models/cnn.py",
                                 "data/images.py", "data/dirichlet.py"])
def test_the_fault_and_checkpoint_modules_stand_alone(rel):
    """The fault slice's and the image slice's modules are among the files
    checked above and import torch, numpy and the standard library only
    (hashlib for the checkpoint's sha256, functools for the CNN's cached
    patch index), besides the port itself."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in PORT_FILES
    roots = set(_imported_roots(path))
    assert not roots & (BANNED | {"."})
    assert roots <= {"__future__", "dataclasses", "functools", "hashlib", "json", "math", "os",
                     "re", "time", "typing", "numpy", "torch", "repro_torch"}, roots


def test_the_compression_module_stands_alone():
    """The compression slice's module is among the files checked above and
    imports torch, numpy and the standard library only, besides the port."""
    path = ROOT / "src" / "repro_torch" / "core" / "compression.py"
    assert path in PORT_FILES
    roots = set(_imported_roots(path))
    assert not roots & (BANNED | {"."})
    assert roots <= {"__future__", "math", "typing", "numpy", "torch", "repro_torch"}, roots
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
            "import repro_torch.core.compression as c\n"
            "assert c.COMPRESS_TAG == 2**31 - 4\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


TRAIN_MODULES = ["launch/train.py", "launch/rules.py", "telemetry/__init__.py",
                 "telemetry/trackers.py", "data/tokens.py", "models/transformer.py",
                 "models/attention.py", "models/ssm.py", "core/clipping.py", "convert.py",
                 "models/moe.py", "models/encdec.py", "models/common.py", "launch/serve.py"]
TRAIN_EXAMPLE = ROOT / "examples" / "train_federated_lm_torch.py"


@pytest.mark.parametrize("rel", TRAIN_MODULES)
def test_the_training_modules_stand_alone(rel):
    """The training slice's modules are among the files checked above and
    import torch, numpy and the standard library only, besides the port
    (and wandb, inside ``WandbTracker``'s constructor, as the JAX package)."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in PORT_FILES
    roots = set(_imported_roots(path))
    assert not roots & (BANNED | {"."})
    allowed = {"__future__", "dataclasses", "functools", "json", "math", "os", "typing",
               "numpy", "torch", "repro_torch"}
    if rel == "telemetry/trackers.py":
        allowed.add("wandb")
    assert roots <= allowed, roots


def test_the_training_example_stands_alone():
    """examples/train_federated_lm_torch.py imports neither jax nor the JAX
    package, and runs its argument parser with both blocked."""
    assert not set(_imported_roots(TRAIN_EXAMPLE)) & (BANNED | {"."})
    code = ("import sys, importlib.util\n"
            "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
            f"spec = importlib.util.spec_from_file_location('ex', {str(TRAIN_EXAMPLE)!r})\n"
            "ex = importlib.util.module_from_spec(spec); spec.loader.exec_module(ex)\n"
            "a = ex.parse_args(['--device', 'cpu'])\n"
            "assert a.device == 'cpu' and a.algorithm == 'cdp-fedexp'\n"
            "assert ex.parse_args([]).device == 'cuda'\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


SCAN_MODULES = ["telemetry/tap.py", "fedsim/scan.py", "fedsim/server.py"]
QUICKSTART = ROOT / "examples" / "quickstart_torch.py"


@pytest.mark.parametrize("rel", SCAN_MODULES)
def test_the_tap_and_scan_modules_stand_alone(rel):
    """The tap's and the scan engine's modules are among the files checked
    above and import torch, numpy and the standard library only (traceback
    names the operation a failed capture stopped at, warnings the deprecated
    shims' one warning), besides the port."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in PORT_FILES
    roots = set(_imported_roots(path))
    assert not roots & (BANNED | {"."})
    assert roots <= {"__future__", "collections", "dataclasses", "math", "time", "traceback",
                     "typing", "warnings", "numpy", "torch", "repro_torch"}, roots


def test_the_quickstart_example_stands_alone(tmp_path):
    """examples/quickstart_torch.py imports neither jax nor the JAX package,
    and its --quick --cpu run works with both blocked."""
    assert not set(_imported_roots(QUICKSTART)) & (BANNED | {"."})
    code = ("import sys, runpy\n"
            "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
            f"sys.argv = ['q', '--quick', '--cpu', '--telemetry', {str(tmp_path / 'q.jsonl')!r}]\n"
            f"runpy.run_path({str(QUICKSTART)!r}, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=tmp_path,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "cdp-fedexp" in proc.stdout
    assert (tmp_path / "q-cdp-fedexp.jsonl").read_text().count("\n") == 8
