"""Production-mesh dry-run: lay every (arch x input shape) out on the 16 x 16
or 2 x 16 x 16 mesh, count one step on the meta device and write its
per-device memory, cost, collectives and roofline terms (counterpart of
repro/launch/dryrun.py).

Run it as its own process: it makes a fake process group of 256 or 512
ranks (``launch.mesh.fake_process_group``), as the JAX dry-run forces 512
host devices before JAX starts.

    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod
    python -m repro_torch.launch.dryrun ... --out results/dryrun_torch

Per combo it writes ``<out>/<arch>__<shape>__<mesh>.json``.  Nothing runs
on a card and no hand-written kernel is launched: the model is built on the
meta device with the JAX package's default attention, ``xla_flash``, and its
step (``FederatedTrainer``'s round, ``ServeEngine``'s prefill or decode
step) is counted by ``op_cost.OpCounter`` under the rules of
``launch/rules.py``, so the MoE dispatches in the mesh's groups.

What the numbers are (per device, as the JAX package's):

  - ``memory.argument_bytes`` / ``output_bytes``: exact, the bytes each
    device holds of the step's arguments (the parameters and the input
    specs of ``launch/specs.py``) and outputs under their placements;
  - ``memory.temp_bytes``: an estimate, the traced step's live-tensor
    high-water mark (outputs included) over the devices that split one
    client's work (the model axis and the batch rule's axes); ``peak_bytes``
    = arguments + temporaries;
  - ``cost.flops`` / ``bytes_accessed``: the counted step (one and two
    blocks, and for training one and two clients, extended to the model's
    depth and the cohort: ``op_cost.extend``) over the devices that split
    it (the client and batch axes the token input is split on, times the
    model axis; an axis that splits nothing holds a replica);
  - ``collective_bytes``: modelled from the placements
    (``roofline.collective_bytes``);
  - ``trace_s`` in place of the JAX ``lower_s`` and ``compile_s``, ``ops``
    (operations dispatched by the extended step) in place of ``hlo_lines``.

A training step is counted with its noise materialized (``train_step(...,
noise=)`` with meta tensors), so it reads no host scalar; the device's
normal draws are added as the bytes they write.  A decode step's position is
the cache's last slot, a host integer, as the port's decode step takes it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Callable

import torch

from repro_torch.configs import ARCHS, SHAPES, FederatedConfig, reduced
from repro_torch.core.compose import CentralGaussian, GaussianLDP
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.op_cost import Cost, count, extend
from repro_torch.launch.roofline import collective_bytes, model_flops, roofline_terms
from repro_torch.launch.rules import (count_params, make_rules, tree_local_bytes,
                                      tree_shardings)
from repro_torch.launch.serve import ServeEngine
from repro_torch.launch.train import FederatedTrainer, TrainNoise
from repro_torch.models import build_model as _build
from repro_torch.models.sharding import AXIS_SIZES_KEY, axis_rules

__all__ = ["build_model", "active_params", "param_shapes", "trace_one", "run_one", "eligible",
           "main"]

_META = torch.device("meta")
_STACKS = ("blocks", "enc_blocks", "dec_blocks")


def build_model(cfg, *, attn_impl: str = "xla_flash", remat_policy: str | None = None,
                device="meta"):
    """``cfg``'s model in bf16, on the meta device unless ``device`` says otherwise."""
    kwargs = dict(dtype=torch.bfloat16, attn_impl=attn_impl, device=device)
    if cfg.arch_type != "audio":
        kwargs["remat_policy"] = remat_policy
    return _build(cfg, **kwargs)


def active_params(cfg, model, total: int) -> int:
    """6 N_active D convention for MoE: the router always, top_k / E of the
    experts' mass."""
    if not cfg.num_experts:
        return total
    expert_mass = sum(p.numel() for n, p in model.named_parameters()
                      if n.rsplit(".", 1)[-1] in ("moe_wi", "moe_wo"))
    return total - expert_mass + int(expert_mass * cfg.top_k / cfg.num_experts)


def param_shapes(model) -> dict:
    """The parameters as the JAX package's tree of stacked (L, ...) leaves,
    meta tensors matching ``model.pspecs()``."""
    named = dict(model.named_parameters())
    out = {}
    for key, spec in model.pspecs().items():
        if not isinstance(spec, dict):
            out[key] = torch.empty(named[key].shape, dtype=named[key].dtype, device=_META)
        elif key in _STACKS:
            layers = len(getattr(model, key))
            out[key] = {n: torch.empty((layers, *named[f"{key}.0.{n}"].shape),
                                       dtype=named[f"{key}.0.{n}"].dtype, device=_META)
                        for n in spec}
        else:
            out[key] = {n: torch.empty(named[f"{key}.{n}"].shape,
                                       dtype=named[f"{key}.{n}"].dtype, device=_META)
                        for n in spec}
    return out


def _unit(cfg) -> tuple[int, Callable[[int], dict]]:
    """(the identical blocks of ``cfg``'s stack, a function of u giving the
    config changes that make a stack of u of them)."""
    if cfg.arch_type == "hybrid":
        every = cfg.hybrid_attn_every
        return cfg.num_layers // every, lambda u: dict(num_layers=u * every)
    if cfg.arch_type == "audio":
        if cfg.num_encoder_layers != cfg.num_layers:
            raise ValueError(f"{cfg.name}: an enc-dec unit is one encoder and one decoder "
                             "layer; the depths differ")
        return cfg.num_layers, lambda u: dict(num_layers=u, num_encoder_layers=u)
    return cfg.num_layers, lambda u: dict(num_layers=u)


def _meta_noise(alg, params: dict, k: int) -> tuple[TrainNoise, int]:
    """(a round's noise as meta tensors, the bytes its draws write)."""
    mech = alg.mechanism
    xi = torch.empty((), device=_META) \
        if alg.step.uses_extrapolation and mech.needs_xi_key else None
    if isinstance(mech, GaussianLDP):
        tree = {n: torch.empty((k, *p.shape), dtype=p.dtype, device=_META)
                for n, p in params.items()}
    elif isinstance(mech, CentralGaussian):
        tree = {n: torch.empty(p.shape, dtype=p.dtype, device=_META) for n, p in params.items()}
    else:
        tree = None
    written = 0 if tree is None else sum(t.numel() * t.element_size() for t in tree.values())
    return TrainNoise(tree=tree, xi=xi), written


def _train_cost(model, fed, n_params: int, k: int, b: int, s: int, audio: bool) -> Cost:
    """One round of ``k`` clients, each ``fed.local_steps`` steps of (b, s)."""
    cfg = model.cfg
    trainer = FederatedTrainer(model, fed, n_params)
    alg = trainer.server_algorithm(k * fed.virtual_clients)
    params = {n: p for n, p in model.named_parameters()}
    tau = fed.local_steps
    n_tok = specs_mod.WHISPER_DECODER_LEN if audio else s
    tok = torch.empty((k, tau, b, n_tok), dtype=torch.int32, device=_META)
    batch = {"tokens": tok, "labels": tok}
    if audio:
        batch["frames"] = torch.empty((k, tau, b, s, cfg.d_model), dtype=torch.bfloat16,
                                      device=_META)
    noise, written = _meta_noise(alg, params, k)
    cost, _ = count(trainer.make_train_step(k), params, batch, torch.Generator(), noise=noise)
    cost.bytes += written
    return cost


def _serve_cost(model, shape) -> Cost:
    """One prefill or decode step of ``shape`` (global batch)."""
    cfg = model.cfg
    audio = cfg.arch_type == "audio"
    engine = ServeEngine(model, is_encdec=audio)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        caches = model.init_cache(b, s)
        token = torch.empty((b,), dtype=torch.int32, device=_META)
        args = (token, s - 1, caches)
        if audio:
            args += (torch.empty((b, specs_mod.WHISPER_ENC_FRAMES, cfg.d_model),
                                 dtype=torch.bfloat16, device=_META),)
        cost, _ = count(engine.make_decode_step(), *args)
        return cost
    if audio:
        caches = model.init_cache(b, specs_mod.WHISPER_DECODER_LEN)
        frames = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16, device=_META)
        tokens = torch.empty((b, specs_mod.WHISPER_DECODER_LEN), dtype=torch.int32,
                             device=_META)
        cost, _ = count(engine.make_prefill_step(), frames, tokens, caches)
        return cost
    caches = model.init_cache(b, s)
    tokens = torch.empty((b, s), dtype=torch.int32, device=_META)
    cost, _ = count(engine.make_prefill_step(), tokens, caches)
    return cost


def trace_one(cfg, shape, *, fed: FederatedConfig, rules: dict, n_params: int, cohort_k: int,
              attn_impl: str = "xla_flash", remat_policy: str | None = None,
              units: int | None = None) -> Cost:
    """The counted cost of one step of ``cfg`` at ``shape`` under ``rules``
    (global shapes: the whole cohort, the whole batch).  The stack is counted
    at one and two identical blocks and extended to its depth (``units``
    blocks; default the model's), and a round at one and two clients and
    extended to ``cohort_k`` (each client's work is the same)."""
    full, changes = _unit(cfg)
    units = full if units is None else units

    def at(u: int, k: int | None = None) -> Cost:
        small = dataclasses.replace(cfg, **changes(u))
        model = build_model(small, attn_impl=attn_impl, remat_policy=remat_policy)
        with axis_rules(rules):
            if shape.kind != "train":
                return _serve_cost(model, shape)
            b = shape.global_batch // cohort_k
            return _train_cost(model, fed, n_params, k, b, shape.seq_len,
                               cfg.arch_type == "audio")

    if shape.kind != "train":
        return extend(at(1), at(2), units)
    one = extend(at(1, 1), at(2, 1), units)
    two = extend(at(1, 2), at(2, 2), units)
    return extend(one, two, cohort_k)


def _mesh(multi_pod: bool, test_mesh: tuple[int, int] | None):
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    if test_mesh is not None:
        return make_test_mesh(*test_mesh, device_type="cpu"), "x".join(map(str, test_mesh))
    return (make_production_mesh(multi_pod=multi_pod, device_type="cpu"),
            "2x16x16" if multi_pod else "16x16")


def _split(sharding, dims) -> int:
    """The devices splitting ``dims`` of a leaf laid out by ``sharding``."""
    total = 1
    for d in dims:
        ax = sharding.spec[d]
        for a in () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax):
            total *= sharding.sizes[a]
    return total


def run_one(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
            fed: FederatedConfig, attn_impl: str = "xla_flash", tag: str = "",
            remat_policy: str | None = None, test_mesh: tuple[int, int] | None = None,
            reduce: bool = False) -> dict:
    """Dry-run one (arch x shape) and write its JSON to ``out_dir``.  Needs a
    process group of the mesh's size (``main`` makes a fake one)."""
    cfg = reduced(ARCHS[arch]) if reduce else ARCHS[arch]
    shape = SHAPES[shape_name]
    mesh, mesh_name = _mesh(multi_pod, test_mesh)
    chips = math.prod(tuple(mesh.shape))
    t0 = time.time()
    model = build_model(cfg, attn_impl=attn_impl, remat_policy=remat_policy)
    n_params = count_params(cfg)
    mode = "train" if shape.kind == "train" else "serve"
    rules = make_rules(cfg, mesh, mode=mode, num_params=n_params)
    pshard = tree_shardings(mesh, param_shapes(model), model.pspecs(), rules)
    audio = cfg.arch_type == "audio"
    fed_info = None
    k = 1
    if shape.kind == "train":
        k = specs_mod.cohort_size(mesh, rules)
        ishapes, ilogical = specs_mod.train_input_specs(cfg, shape, fed, mesh, rules)
        trainer = FederatedTrainer(model, fed, n_params)
        # resolve through the registry up front: an unsupported algorithm
        # fails here with a clear message
        alg = trainer.server_algorithm(k * fed.virtual_clients)
        sizes = dict(zip(tuple(mesh.mesh_dim_names), tuple(mesh.shape)))
        spec_identity = " | ".join([
            f"algorithm={alg.name}", f"train={trainer.train!r}", f"fed={fed!r}",
            f"mesh[{','.join(f'{a}={n}' for a, n in sorted(sizes.items()))}]",
            f"cohort_k={k}", f"virtual_clients={fed.virtual_clients}"])
        fed_info = {"algorithm": alg.name, "is_private": alg.is_private, "cohort_k": k,
                    "tau": trainer.train.tau, "eta_l": trainer.train.eta_l,
                    "spec_identity": spec_identity}
        tok_dims, batch_dims = (0, 2), (2,)
        tokens = shape.global_batch * fed.local_steps * (
            specs_mod.WHISPER_DECODER_LEN if audio else shape.seq_len)
    elif shape.kind == "decode":
        ishapes, ilogical = specs_mod.decode_input_specs(cfg, shape, mesh, rules, model)
        tok_dims = batch_dims = (0,)
        tokens = shape.global_batch
    else:
        ishapes, ilogical = specs_mod.prefill_input_specs(cfg, shape, mesh, rules, model)
        tok_dims = batch_dims = (0,)
        tokens = shape.global_batch * shape.seq_len
    ishard = specs_mod.tree_input_shardings(mesh, ishapes, ilogical, rules)
    tok = ishard["token" if shape.kind == "decode" else "tokens"]
    model_split = rules[AXIS_SIZES_KEY].get("model", 1)
    work_split = _split(tok, tok_dims) * model_split          # the devices splitting the step
    client_split = _split(tok, batch_dims) * model_split      # ... one client's part of it
    seqs = shape.global_batch // k // _split(tok, batch_dims)  # a device's sequences

    cost = trace_one(cfg, shape, fed=fed, rules=rules, n_params=n_params, cohort_k=k,
                     attn_impl=attn_impl, remat_policy=remat_policy)
    t_trace = time.time() - t0

    param_bytes = tree_local_bytes(pshard)
    argument_bytes = param_bytes + tree_local_bytes(ishard)
    if shape.kind == "train":
        # new parameters laid out as the old; loss, eta_g, the mean norm, agg_sq
        # and the K client and clipped norms, replicated float32
        output_bytes = param_bytes + 4 * (4 + 2 * k)
    else:
        b = shape.global_batch
        out_logical = {"token": ("batch",), "caches": ilogical["caches"]}
        out_shapes = {"token": torch.empty((b,), dtype=torch.int64, device=_META),
                      "caches": ishapes["caches"]}
        if shape.kind == "decode":
            out_logical["logits"] = ("batch", "vocab")
            out_shapes["logits"] = torch.empty((b, cfg.vocab_size), dtype=torch.bfloat16,
                                               device=_META)
        elif audio:
            out_logical["enc_out"] = ("batch", "seq", None)
            out_shapes["enc_out"] = torch.empty((b, shape.seq_len, cfg.d_model),
                                                dtype=torch.bfloat16, device=_META)
        output_bytes = tree_local_bytes(tree_shardings(mesh, out_shapes, out_logical, rules))
    temp_bytes = cost.temp_bytes / client_split
    flops, bytes_acc = cost.flops / work_split, cost.bytes / work_split
    if shape.kind == "decode":
        per_seq = 1
    else:
        per_seq = specs_mod.WHISPER_DECODER_LEN if audio else shape.seq_len
    enc_tokens = seqs * shape.seq_len if audio and shape.kind != "decode" else 0
    coll = collective_bytes(cfg, shape.kind, pshard, rules, tokens=seqs * per_seq, batch=seqs,
                            tau=fed.local_steps, enc_tokens=enc_tokens)
    coll_total = sum(coll.values())
    terms = roofline_terms(flops, bytes_acc, coll_total)
    mflops = model_flops(n_params, active_params(cfg, model, n_params), tokens, shape.kind)

    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "kind": shape.kind,
        "fed": fed_info,
        "num_params": n_params,
        "tokens_per_step": tokens,
        "trace_s": round(t_trace, 1),
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": temp_bytes,
            "peak_bytes": argument_bytes + temp_bytes,
        },
        "cost": {"flops": flops, "bytes_accessed": bytes_acc, "split_devices": work_split,
                 "traced_flops": cost.flops, "traced_bytes": cost.bytes},
        "collective_bytes": coll,
        "collective_total": coll_total,
        "roofline": terms,
        "model_flops": mflops,
        "useful_ratio": (mflops / chips) / flops if flops else None,
        "ops": cost.ops,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}{tag}.json"),
                  "w") as f:
            json.dump(result, f, indent=1)
    return result


def eligible(arch: str, shape_name: str) -> bool:
    """Dense full-attention archs skip the 500k decode (DESIGN.md §6)."""
    return not (shape_name == "long_500k" and not ARCHS[arch].subquadratic)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--attn-impl", default="xla_flash")
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--algorithm", default="cdp-fedexp")
    ap.add_argument("--tag", default="")
    ap.add_argument("--test-mesh", default=None,
                    help="DATAxMODEL: a small test mesh in place of the production one")
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' reduced forms (configs.reduced), for tests")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import fake_process_group
    test_mesh = None if args.test_mesh is None else tuple(
        int(n) for n in args.test_mesh.split("x"))
    world = math.prod(test_mesh) if test_mesh else (512 if args.multi_pod else 256)
    fake_process_group(world)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    fed = FederatedConfig(algorithm=args.algorithm, local_steps=args.tau)

    failures = []
    t_all = time.time()
    for arch in archs:
        for shape in shapes:
            if not eligible(arch, shape):
                print(f"SKIP  {arch} x {shape} (full-attention arch; long_500k gate)")
                continue
            try:
                r = run_one(arch, shape, multi_pod=args.multi_pod, out_dir=args.out, fed=fed,
                            attn_impl=args.attn_impl, tag=args.tag,
                            remat_policy=args.remat_policy, test_mesh=test_mesh,
                            reduce=args.reduced)
                rt = r["roofline"]
                print(f"OK    {arch} x {shape} [{r['mesh']}] trace={r['trace_s']}s "
                      f"flops={r['cost']['flops']:.3g} coll={r['collective_total']:.3g}B "
                      f"bottleneck={rt['bottleneck']}", flush=True)
            except Exception as e:  # noqa: BLE001 - report and continue
                failures.append((arch, shape, repr(e)))
                print(f"FAIL  {arch} x {shape}: {e!r}", flush=True)
                traceback.print_exc()
    print(f"\nwall {time.time() - t_all:.1f} s")
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print(" ", f)
        sys.exit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
