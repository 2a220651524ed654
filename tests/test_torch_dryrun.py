"""The port's dry-run pieces against the JAX package's, on the CPU.

``roofline_terms``, ``model_flops`` and ``active_params`` equal JAX's
exactly (the same ``Hardware`` passed to both); ``op_cost``'s FLOPs equal
``hlo_cost``'s of the same function jitted on the CPU, exactly (a product, a
batched einsum, an L-step loop); the dry-run's one-and-two-blocks extension
equals a full trace at reduced depth for every stack kind; and reduced
dry-runs on a fake group of 8 ranks (data 2, model 4), in a subprocess,
whose ``argument_bytes`` equal the bytes of the same leaves laid out by
JAX's ``safe_pspec``, whose ``spec_identity`` is the JAX dry-run's string,
and in which ``op_cost`` counts functional collectives by kind.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported (512 host
devices, for its own process); the test restores the variable at once, so
no later JAX backend sees it.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import rules as jrules  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.hlo_cost import hlo_cost  # noqa: E402
from repro.launch.train import FederatedTrainer as JaxTrainer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, op_cost, roofline, rules  # noqa: E402
from repro_torch.models.sharding import axis_rules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(configs.ARCHS)
KEYS = ("arch", "shape", "mesh", "chips", "kind", "fed", "num_params", "tokens_per_step",
        "trace_s", "memory", "cost", "collective_bytes", "collective_total", "roofline",
        "model_flops", "useful_ratio", "ops")
MEMORY_KEYS = ("argument_bytes", "output_bytes", "temp_bytes", "peak_bytes")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread (a pool of them only contends)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


class PortMesh:
    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = shape


@pytest.mark.parametrize("hw", [(197e12, 819e9, 50e9), (989e12, 3.35e12, 450e9)])
def test_roofline_terms(hw):
    jhw, phw = jroofline.Hardware(*hw), roofline.Hardware(*hw)
    rng = np.random.default_rng(0)
    for flops, nbytes, coll in rng.uniform(0, 1e15, size=(20, 3)):
        assert roofline.roofline_terms(flops, nbytes, coll, phw) == \
            jroofline.roofline_terms(flops, nbytes, coll, jhw)
    assert roofline.roofline_terms(1.0, 0.0, 0.0, phw)["bottleneck"] == "compute_s"


def test_h100_constants():
    assert roofline.HW == roofline.Hardware(989e12, 3.35e12, 450e9)


def test_model_flops():
    for n, a, t, kind in ((10**9, 4 * 10**8, 4096, "train"), (7, 7, 128, "decode"),
                          (123456789, 9876543, 32768 * 32, "prefill")):
        assert roofline.model_flops(n, a, t, kind) == jroofline.model_flops(n, a, t, kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params(arch):
    cfg = configs.ARCHS[arch]
    total = rules.count_params(cfg)
    jcfg = jconfigs.ARCHS[arch]
    want = jdryrun.active_params(jcfg, jdryrun.build_model(jcfg), total)
    assert dryrun.active_params(cfg, dryrun.build_model(cfg), total) == want


def jax_flops(fn, *args):
    return hlo_cost(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def test_op_cost_matches_hlo_cost():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((64, 128), np.float32), rng.standard_normal((128, 32), np.float32)
    got, _ = op_cost.count(lambda x, y: x @ y, torch.tensor(a), torch.tensor(b))
    assert got.flops == jax_flops(lambda x, y: x @ y, a, b) == 2 * 64 * 128 * 32

    x, y = rng.standard_normal((4, 16, 32), np.float32), rng.standard_normal((4, 32, 8),
                                                                             np.float32)
    got, _ = op_cost.count(lambda p, q: torch.einsum("bij,bjk->bik", p, q), torch.tensor(x),
                           torch.tensor(y))
    assert got.flops == jax_flops(lambda p, q: jnp.einsum("bij,bjk->bik", p, q), x, y)

    steps = 5
    h, w = rng.standard_normal((8, 32), np.float32), rng.standard_normal((32, 32), np.float32)

    def torch_loop(h, w):
        for _ in range(steps):
            h = torch.tanh(h @ w)
        return h

    def jax_loop(h, w):
        return jax.lax.fori_loop(0, steps, lambda i, v: jnp.tanh(v @ w), h)

    got, _ = op_cost.count(torch_loop, torch.tensor(h), torch.tensor(w))
    assert got.flops == jax_flops(jax_loop, h, w) == steps * 2 * 8 * 32 * 32


def test_op_cost_bytes_and_memory():
    """Bytes: operands plus results of data-moving ops; a view moves none.
    The high-water mark: what the function made and held at once."""
    a = torch.empty(64, 128, device="meta")

    def fn(x):
        y = x * 2
        z = y + 1
        del y
        return z.T.sum()

    got, _ = op_cost.count(fn, a)
    n = 64 * 128 * 4
    assert got.bytes == (n + n) + (n + n) + (n + 4)      # mul, add, sum; the view is free
    assert got.temp_bytes == 2 * n
    assert got.ops == 4


def small_rules(cfg, mode):
    mesh = PortMesh((2, 4), ("data", "model"))
    return rules.make_rules(cfg, mesh, mode=mode, num_params=rules.count_params(cfg))


SHAPES = {"train": ShapeConfig("t", 32, 6, "train"), "prefill": ShapeConfig("p", 32, 2, "prefill"),
          "decode": ShapeConfig("d", 32, 2, "decode")}
# every stack kind's serve steps; training for the MoE (three clients, so
# the client extension is held too), the hybrid (its unit a super-block, the
# shared block's gradients summed over its sites) and the enc-dec (its unit
# one encoder and one decoder layer)
DEPTH_CASES = [(arch, kind) for arch in ("granite-moe-1b-a400m", "h2o-danube-3-4b",
                                         "mamba2-2.7b", "zamba2-2.7b", "whisper-large-v3")
               for kind in ("prefill", "decode")] + [
    ("granite-moe-1b-a400m", "train"), ("zamba2-2.7b", "train"), ("whisper-large-v3", "train")]


@pytest.mark.parametrize("arch,kind", DEPTH_CASES)
def test_depth_extension_matches_full_trace(arch, kind):
    """One and two blocks (and one and two clients) extended = a full trace
    of three blocks (and three clients): FLOPs, bytes and ops exactly."""
    units = 3
    cfg = configs.reduced(configs.ARCHS[arch], layers=1)
    _, changes = dryrun._unit(cfg)
    deep = dataclasses.replace(cfg, **changes(units))
    fed = configs.FederatedConfig(local_steps=1)
    shape = SHAPES[kind]
    r = small_rules(cfg, "train" if kind == "train" else "serve")
    n = rules.count_params(cfg)
    k = 3 if arch == "granite-moe-1b-a400m" else 2
    got = dryrun.trace_one(cfg, shape, fed=fed, rules=r, n_params=n, cohort_k=k, units=units)
    model = dryrun.build_model(deep)
    with axis_rules(r):
        if kind == "train":
            want = dryrun._train_cost(model, fed, n, k, 6 // k, 32, cfg.arch_type == "audio")
        else:
            want = dryrun._serve_cost(model, shape)
    assert (got.flops, got.bytes, got.ops) == (want.flops, want.bytes, want.ops)


def jax_local_bytes(shapes, logical, rules_, mesh):
    leaves = jax.tree_util.tree_leaves(shapes)
    logs = jax.tree_util.tree_leaves(logical, is_leaf=lambda x: isinstance(x, tuple))
    assert len(leaves) == len(logs)
    total = 0
    for leaf, lg in zip(leaves, logs):
        spec = tuple(jrules.safe_pspec(leaf.shape, lg, rules_, mesh))
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        n = 1
        for dim, ax in zip(leaf.shape, spec):
            axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
            n *= dim // int(np.prod([sizes[a] for a in axes]))
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def jax_argument_bytes(arch, shape_name, mesh, tau):
    cfg = jconfigs.reduced(jconfigs.ARCHS[arch])
    shape = jconfigs.SHAPES[shape_name]
    model = jdryrun.build_model(cfg)
    n = jrules.count_params(model)
    mode = "train" if shape.kind == "train" else "serve"
    r = jrules.make_rules(cfg, mesh, mode=mode, num_params=n)
    pshapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    total = jax_local_bytes(pshapes, model.pspecs(), r, mesh)
    if shape.kind == "train":
        fed = jconfigs.FederatedConfig(algorithm="cdp-fedexp", local_steps=tau)
        ish, ilog = jspecs.train_input_specs(cfg, shape, fed, mesh, r)
        k = jspecs.cohort_size(mesh, r)
        trainer = JaxTrainer(model, fed, n)
        alg = trainer.server_algorithm(k * fed.virtual_clients)
        identity = " | ".join([
            f"algorithm={alg.name}", f"train={trainer.train!r}", f"fed={fed!r}",
            f"mesh[{','.join(f'{a}={n}' for a, n in sorted(zip(mesh.axis_names, mesh.devices.shape)))}]",
            f"cohort_k={k}", f"virtual_clients={fed.virtual_clients}"])
    else:
        fn = jspecs.decode_input_specs if shape.kind == "decode" else jspecs.prefill_input_specs
        ish, ilog = fn(cfg, shape, mesh, r, model)
        identity = None
    return total + jax_local_bytes(ish, ilog, r, mesh), identity


SCRIPT = """
import sys
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as fc
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import count
dryrun.main(sys.argv[1:])                     # makes the fake group of 8 ranks
try:
    make_production_mesh(device_type="cpu")
    raise SystemExit("a 16 x 16 mesh on 8 ranks")
except ValueError:
    pass
x = torch.ones(8, 4)
def f(x):
    a = fc.all_reduce(x, "sum", dist.group.WORLD)
    b = fc.all_gather_single(x, 0, dist.group.WORLD)
    c = fc.reduce_scatter_single(x, "sum", 0, dist.group.WORLD)
    return a + 1, b * 2, c * 3
cost, _ = count(f, x)
print(cost.collective_bytes)
"""
ARCH, SHAPE, TAU = "granite-moe-1b-a400m", "train_4k", 1


def test_reduced_dryrun_on_a_fake_group(tmp_path):
    """One reduced dry-run (train_4k, tau 1) on a fake group of 8 ranks as
    (data 2, model 4); then, on the same group, functional collectives
    counted by kind (result bytes) and a 16 x 16 mesh refused."""
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, "--arch", ARCH, "--shape", SHAPE, "--tau", str(TAU),
         "--test-mesh", "2x4", "--reduced", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    r = json.loads((out / f"{ARCH}__{SHAPE}__2x4.json").read_text())
    assert set(KEYS) <= set(r) and set(MEMORY_KEYS) <= set(r["memory"])
    assert r["chips"] == 8 and r["kind"] == "train"
    want, identity = jax_argument_bytes(ARCH, SHAPE, JaxMesh((2, 4), ("data", "model")), TAU)
    assert r["memory"]["argument_bytes"] == want
    assert r["fed"]["spec_identity"] == identity
    assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"]
    assert r["cost"]["flops"] > 0 and r["ops"] > 0
    assert set(r["collective_bytes"]) == set(roofline.COLLECTIVE_KINDS)
    assert r["roofline"]["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    got = eval(proc.stdout.strip().splitlines()[-1])
    assert got == {"all-reduce": 128.0, "all-gather": 1024.0, "reduce-scatter": 16.0,
                   "all-to-all": 0.0, "collective-permute": 0.0}
