"""The port's launch layer — sharding rules, parameter layouts, cache axes and
input specs — against the JAX package's, exactly.

``make_rules`` for all ten archs in both modes on the production meshes (16 x
16, 2 x 16 x 16) and two test meshes; ``safe_pspec`` of every parameter of
every arch at full size from both packages' ``pspecs()``, and the port's
``tree_shardings`` (its spec and its ``torch.distributed.tensor``
placements); ``cache_logical`` and the three input specs of every eligible
(arch x shape).  The JAX functions read a mesh's ``axis_names`` and
``devices.shape`` alone, the port's its ``mesh_dim_names`` and ``shape``, so
both get a stand-in with those attributes (no device is made).  The port's
caches are per layer where JAX stacks them on a leading "layers" axis: a
port leaf must equal each row of the JAX leaf, in shape, dtype, logical axes
(JAX's less "layers") and placement (JAX's less its replicated first dim).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import rules as jrules  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.encdec import EncDecLM as JaxEncDecLM  # noqa: E402
from repro.models.transformer import DecoderLM as JaxDecoderLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import rules, specs  # noqa: E402
from repro_torch.launch.dryrun import build_model, eligible, param_shapes  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "test 2x4": ((2, 4), ("data", "model")),
          "test 1x1": ((1, 1), ("data", "model"))}
ARCHS = list(configs.ARCHS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread (a pool of them only contends)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxMesh:
    """What the JAX launch functions read of a ``Mesh``."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


class PortMesh:
    """What the port's read of a ``DeviceMesh``."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = shape


def meshes(name):
    shape, names = MESHES[name]
    return JaxMesh(shape, names), PortMesh(shape, names)


_JAX_MODELS: dict = {}


def jax_model(arch):
    if arch not in _JAX_MODELS:
        cfg = jconfigs.ARCHS[arch]
        cls = JaxEncDecLM if cfg.arch_type == "audio" else JaxDecoderLM
        _JAX_MODELS[arch] = cls(cfg, dtype=jnp.bfloat16)
    return _JAX_MODELS[arch]


def n_params(arch):
    return rules.count_params(configs.ARCHS[arch])


def jax_leaves(tree):
    """(path, leaf) of a JAX tree of shapes, dict keys joined by '/'."""
    return {"/".join(str(p.key) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_leaves(tree, prefix=""):
    """(path, leaf) of the port's tree of tensors or logical tuples; list
    entries keyed by their index."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(port_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def logical_leaves(tree, prefix=""):
    """(path, logical tuple) of a logical tree (a tuple is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(logical_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(logical_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_make_rules(arch, mesh_name):
    jmesh, pmesh = meshes(mesh_name)
    n = n_params(arch)
    for mode in ("train", "serve"):
        want = jrules.make_rules(jconfigs.ARCHS[arch], jmesh, mode=mode, num_params=n)
        got = rules.make_rules(configs.ARCHS[arch], pmesh, mode=mode, num_params=n)
        assert got == want, (arch, mode)


def test_count_params_and_giant():
    for arch in ARCHS:
        n = n_params(arch)
        assert n == jrules.count_params(jax_model(arch)), arch
        assert rules.is_giant(configs.ARCHS[arch], n) == jrules.is_giant(
            jconfigs.ARCHS[arch], n)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_layouts(arch, mesh_name):
    """Every parameter at full size: the same logical axes, safe_pspec's
    spec, and the port's placements splitting exactly the spec's dims."""
    jmesh, pmesh = meshes(mesh_name)
    n = n_params(arch)
    jm = jax_model(arch)
    pm = build_model(configs.ARCHS[arch])
    assert pm.pspecs() == jm.pspecs()
    jshapes = jax_leaves(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    pshapes = param_shapes(pm)
    plog = logical_leaves(pm.pspecs())
    for mode in ("train", "serve"):
        jr = jrules.make_rules(jconfigs.ARCHS[arch], jmesh, mode=mode, num_params=n)
        pr = rules.make_rules(configs.ARCHS[arch], pmesh, mode=mode, num_params=n)
        shard = port_leaves(rules.tree_shardings(pmesh, pshapes, pm.pspecs(), pr))
        assert set(shard) == set(jshapes) == set(plog)
        for path, leaf in jshapes.items():
            want = tuple(jrules.safe_pspec(leaf.shape, plog[path], jr, jmesh))
            got = rules.safe_pspec(tuple(leaf.shape), plog[path], pr, pmesh)
            assert got == want, (path, mode)
            s = shard[path]
            assert s.spec == want and s.shape == tuple(leaf.shape), (path, mode)
            assert s.itemsize == np.dtype(leaf.dtype).itemsize
            for axis, p in zip(pmesh.mesh_dim_names, s.placements):
                dims = [d for d, ax in enumerate(want) if ax is not None
                        and axis in ((ax,) if isinstance(ax, str) else ax)]
                if dims:
                    assert p.is_shard(dims[0]), (path, axis, p)
                else:
                    assert p.is_replicate(), (path, axis, p)


def check_input_specs(jshapes, jlogical, pshapes, plogical, jr, pr, jmesh, pmesh):
    """Port input specs = JAX's, leaf by leaf (a per-layer cache leaf against
    each row of JAX's stacked one)."""
    jl = jax_leaves(jshapes)
    jlog = logical_leaves(jlogical)
    pl = port_leaves(pshapes)
    plog = logical_leaves(plogical)
    assert set(pl) == set(plog)
    matched, rows = set(), {}
    for path, leaf in pl.items():
        jpath, layer = jax_path(path, jl)
        want = jl[jpath]
        wlog = jlog[jpath]
        wshape, wspec = tuple(want.shape), tuple(jrules.safe_pspec(want.shape, wlog, jr, jmesh))
        if layer is not None:
            assert wlog[0] == "layers" and wspec[0] is None
            rows.setdefault(jpath, set()).add(layer)
            wshape, wlog, wspec = wshape[1:], wlog[1:], wspec[1:]
        assert tuple(leaf.shape) == wshape, path
        assert dtype_name(leaf.dtype) == str(want.dtype), path
        assert plog[path] == wlog, path
        assert rules.safe_pspec(tuple(leaf.shape), plog[path], pr, pmesh) == wspec, path
        matched.add(jpath)
    assert matched == set(jl)
    for jpath, layers in rows.items():       # one port leaf for every row of JAX's
        assert layers == set(range(jl[jpath].shape[0])), jpath


def jax_path(path: str, jl: dict):
    """The JAX leaf of the port's leaf ``path``, and the layer row it is
    (None for an unstacked leaf)."""
    parts = path.split("/")
    if parts[0] != "caches":
        return path, None
    # caches/<stack>/<i>/<name> in the port: caches/<stack>/<name> in JAX,
    # or caches/<name> for the enc-dec's unwrapped stacked cache
    stack, layer, name = parts[1], int(parts[2]), parts[3]
    for cand in (f"caches/{stack}/{name}", f"caches/{name}"):
        if cand in jl:
            return cand, layer
    raise KeyError(path)


def combos():
    return [(a, s) for a in ARCHS for s in configs.SHAPES if eligible(a, s)]


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape_name", combos())
def test_input_specs(arch, shape_name, mesh_name):
    jmesh, pmesh = meshes(mesh_name)
    n = n_params(arch)
    jcfg, pcfg = jconfigs.ARCHS[arch], configs.ARCHS[arch]
    jshape, pshape = jconfigs.SHAPES[shape_name], configs.SHAPES[shape_name]
    mode = "train" if pshape.kind == "train" else "serve"
    jr = jrules.make_rules(jcfg, jmesh, mode=mode, num_params=n)
    pr = rules.make_rules(pcfg, pmesh, mode=mode, num_params=n)
    assert specs.cohort_size(pmesh, pr) == jspecs.cohort_size(jmesh, jr)
    if pshape.kind == "train":
        jfed, pfed = jconfigs.FederatedConfig(), configs.FederatedConfig()
        jsh, jlog = jspecs.train_input_specs(jcfg, jshape, jfed, jmesh, jr)
        psh, plog = specs.train_input_specs(pcfg, pshape, pfed, pmesh, pr)
    else:
        fn = "decode_input_specs" if pshape.kind == "decode" else "prefill_input_specs"
        jsh, jlog = getattr(jspecs, fn)(jcfg, jshape, jmesh, jr, jax_model(arch))
        psh, plog = getattr(specs, fn)(pcfg, pshape, pmesh, pr, build_model(pcfg))
    assert set(psh) == set(jsh)
    check_input_specs(jsh, jlog, psh, plog, jr, pr, jmesh, pmesh)
    # tree_input_shardings: each leaf's spec is safe_pspec's
    shard = port_leaves(specs.tree_input_shardings(pmesh, psh, plog, pr))
    for path, s in shard.items():
        assert s.spec == rules.safe_pspec(s.shape, logical_leaves(plog)[path], pr, pmesh)


def test_whisper_constants():
    assert specs.WHISPER_DECODER_LEN == jspecs.WHISPER_DECODER_LEN == 256
    assert specs.WHISPER_ENC_FRAMES == jspecs.WHISPER_ENC_FRAMES == 1500


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_logical_every_leaf(arch):
    """``cache_logical`` on the port's per-layer cache = JAX's on its stacked
    cache without "layers", at the 32k decode batch."""
    pm = build_model(configs.ARCHS[arch])
    jm = jax_model(arch)
    caches = pm.init_cache(2, 64)
    jc = jax.eval_shape(lambda: jm.init_cache(2, 64, dtype=jnp.bfloat16))
    plog = logical_leaves(specs.cache_logical(caches))
    jlog = logical_leaves(jspecs.cache_logical(jc))
    jl = {f"caches/{k}": v for k, v in jlog.items()}
    for path, axes in plog.items():
        jpath, layer = jax_path("caches/" + path, jl)
        assert jl[jpath][0] == "layers" and tuple(jl[jpath][1:]) == axes, path


def test_tree_shardings_local_bytes():
    """``Sharding.local_shape`` divides each split dim by its mesh axes."""
    pmesh = PortMesh((2, 16, 16), ("pod", "data", "model"))
    s = rules.leaf_sharding(torch.empty((64, 32, 48), dtype=torch.bfloat16, device="meta"),
                            ("batch", None, "heads"), {"batch": ("pod", "data"),
                                                       "heads": "model"}, pmesh)
    assert s.spec == (("pod", "data"), None, "model")
    assert s.local_shape == (2, 32, 3) and s.local_bytes == 2 * 32 * 3 * 2
    assert rules.tree_local_bytes({"a": s, "b": [s, s]}) == 3 * s.local_bytes
