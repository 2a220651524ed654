"""The e2 CNN's convolutions on the card: patch gathers and products (the
port's) against conv2d's grouped batching rule (the route before).

    python tools/e2_cnn_conv.py            # on a machine with a CUDA card

At e2's size (M = 1000 clients, 12 generated images each, the CDP CNN with
d = 5046 and the LDP CNN with d = 237), for each formulation of
``models/cnn.py::_conv``: the time of one vmapped gradient with per-client
weights (the cohort after its first local step), of the local training of
a round (tau = 10 full-batch steps, and LocalSpec(batch_size=4, epochs=2,
prox_mu=0.01, momentum=0.9)), and a ``torch.profiler`` table of one gradient
(kernels by device time, with their launch counts).  Then cdp-fedexp under
that spec for ROUNDS rounds of CohortSpec(q=0.1), each round retaken
gathered from the dense iterate with the gathered block's own local
training: the largest |w_gathered - w_dense| and the client rows whose
local update moved by more than 1e-5 of max |u|.  Float32 products and
convolutions (no TF32), as chip_smoke.py sets them.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ROUNDS = 12


def conv2d_grouped(x, w, b, stride):
    """The route before: NHWC -> NCHW for ``conv2d`` with the HWIO weight as
    OIHW; under vmap with per-client weights its batching rule makes one
    grouped convolution of M groups."""
    import torch.nn.functional as F
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + b


def ms(fn, n: int = 3) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def timings(images, dev):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.fedsim import LocalSpec, cohort_updates, cohort_updates_spec
    from repro_torch.models.cnn import masked_xent_loss
    spec = LocalSpec(**chip_smoke.E2_LOCAL)
    for setting in ("cdp", "ldp-gauss"):
        model, batches = chip_smoke.e2_problem(setting, 0, images, dev)
        loss = masked_xent_loss(model)
        w0 = model.init_flat
        ws = w0 + 0.01 * torch.randn(chip_smoke.E2[0], model.dim, device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(1))
        grad = torch.func.vmap(torch.func.grad(loss))
        print(f"  d={model.dim}: one vmapped gradient {ms(lambda: grad(ws, batches), 5):.2f} ms; "
              f"local training tau=10 full batch "
              f"{ms(lambda: cohort_updates(loss, w0, batches, 10, 0.1)):.2f} ms, LocalSpec"
              f"{chip_smoke.E2_LOCAL} "
              f"{ms(lambda: cohort_updates_spec(loss, w0, batches, spec, 10, 0.1, 5)):.2f} ms "
              "(host clock, card synchronised)")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            grad(ws, batches)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8,
                                        max_name_column_width=60))


def gathered_retakes(images, dev):
    import torch

    import chip_smoke
    from repro_torch.core.algorithm import round_generator
    from repro_torch.fedsim import CohortSpec, gather_rows, gather_slots
    from repro_torch.fedsim.server import round_step
    m = chip_smoke.E2[0]
    model, batches = chip_smoke.e2_problem("cdp", 0, images, dev)
    session = chip_smoke.e2_session("cdp", "fedexp", model, batches, images, dev,
                                    local=chip_smoke.E2_LOCAL)
    alg, eta_l = session.algorithm, session.train.eta_l
    specs = [CohortSpec(q=0.1), CohortSpec(q=0.1, gather=True)]
    steps = [round_step(alg, session._local_fn, None, 1, spec) for spec in specs]
    w, state = session._w0, alg.init_state(session._w0)
    for t in range(ROUNDS):
        gen = round_generator(0, t)
        mask = specs[0].round_mask(round_generator(0, t), m)
        slots = gather_slots(mask, specs[1].resolved_cap(m))[0]
        on, dslots = int((mask > 0).sum()), slots.to(dev)
        seed = gen.initial_seed()
        dense_u = session._local_fn(w, batches, eta_l, seed=seed, start=0)[dslots[:on]]
        block_u = session._local_fn(w, gather_rows(batches, dslots), eta_l, seed=seed,
                                    start=slots)[:on]
        rows = (dense_u - block_u).abs().amax(dim=1)
        off = int((rows > 1e-5 * float(dense_u.abs().max())).sum()) if on else 0
        w_d, s_d, out_d = steps[0](w, state, round_generator(0, t), t, batches, eta_l)
        w_g, _, out_g = steps[1](w, state, round_generator(0, t), t, batches, eta_l)
        print(f"  round {t:2d}: |w_g - w_d| {float((w_g - w_d).abs().max()):.3e} (max |w| "
              f"{float(w_d.abs().max()):.3f}), eta_g {float(out_d[0]):.4f} vs "
              f"{float(out_g[0]):.4f}; local updates of the {on} sampled clients: max "
              f"{max([0.0] + rows.tolist()):.3e} apart, {off} rows beyond 1e-5 of max |u|")
        w, state = w_d, s_d


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("e2_cnn_conv: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from repro_torch.models import cnn
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    images = chip_smoke.e2_images(dev)
    patches = cnn._conv
    for name, conv in (("patch gathers and products (the port)", patches),
                       ("conv2d, grouped under vmap (the route before)", conv2d_grouped)):
        cnn._conv = conv
        print(f"{name}:")
        timings(images, dev)
        gathered_retakes(images, dev)
    cnn._conv = patches
    return 0


if __name__ == "__main__":
    sys.exit(main())
