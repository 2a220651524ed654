"""End-to-end driver: DP-FedEXP federated training of a transformer LM on the
PyTorch port (counterpart of examples/train_federated_lm.py, with its
arguments and loop).

    PYTHONPATH=src python examples/train_federated_lm_torch.py                # the card
    PYTHONPATH=src python examples/train_federated_lm_torch.py --device cpu   # ~3M params
    PYTHONPATH=src python examples/train_federated_lm_torch.py --d-model 768 \\
        --layers 12 --rounds 200                                              # ~100M-class

Each round is one ``FederatedTrainer`` train_step over a cohort of clients,
each drawing its tokens from its own Markov chain over the vocabulary
(``repro_torch.data.make_client_stream``), so client data is heterogeneous.
Rounds are logged through ``StdoutTracker`` (and, with ``--telemetry``, a
JSONL stream of every round); the last parameters are saved with
``repro_torch.checkpoint.save_checkpoint`` in the JAX package's layout (the
blocks stacked on L), which the JAX package's ``DecoderLM`` loads.
"""
import argparse
import dataclasses
import sys
import time

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import FederatedConfig, get_config, reduced  # noqa: E402
from repro_torch.convert import trainer_params_to_jax  # noqa: E402
from repro_torch.data import make_client_stream  # noqa: E402
from repro_torch.launch import FederatedTrainer, count_params  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402
from repro_torch.telemetry import CompositeTracker, JsonlTracker, StdoutTracker  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", help="family to reduce from")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--algorithm", default="cdp-fedexp")
    ap.add_argument("--ckpt-dir", default="results/ckpt_lm_torch")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="also stream per-round JSONL telemetry to PATH")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    cfg = dataclasses.replace(
        reduced(get_config(args.arch), layers=args.layers, d_model=args.d_model),
        vocab_size=args.vocab)
    model = DecoderLM(cfg, attn_impl="xla_flash", remat=False, device=device,
                      generator=torch.Generator(device=device).manual_seed(0))
    fed = FederatedConfig(algorithm=args.algorithm, local_steps=args.tau,
                          local_lr=0.05, clip_norm=1.0, noise_sigma=0.05)
    n = count_params(cfg)
    print(f"model: {cfg.name} d={args.d_model} L={args.layers} vocab={args.vocab} "
          f"-> {n/1e6:.1f}M params; algorithm={args.algorithm}; device={device}")

    trainer = FederatedTrainer(model, fed, n)
    step = trainer.make_train_step(cohort_k=args.cohort)
    params = {name: p.detach() for name, p in model.named_parameters()}
    stream = make_client_stream(torch.Generator().manual_seed(1), args.cohort, args.vocab)

    # host-driven round loop: StdoutTracker prints every 5 rounds, and
    # --telemetry adds a machine-readable JSONL stream of every round
    tracker = StdoutTracker(every=5, prefix="lm ")
    if args.telemetry is not None:
        tracker = CompositeTracker(tracker, JsonlTracker(args.telemetry))
    tracker.start_phase("train", 0)
    for t in range(args.rounds):
        toks = stream.sample(torch.Generator().manual_seed(2 * 1_000_003 + t), args.tau,
                             args.batch, args.seq + 1).to(device)
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        t0 = time.perf_counter()
        params, metrics = step(params, batch, torch.Generator().manual_seed(3 * 1_000_003 + t))
        tracker.log(t, {"loss": float(metrics["loss"]),
                        "eta": float(metrics["eta_g"]),
                        "update_norm": float(metrics["mean_update_norm"]),
                        "round_time_s": time.perf_counter() - t0})
    tracker.finish()
    path = ckpt.save_checkpoint(args.ckpt_dir, args.rounds, trainer_params_to_jax(params),
                                extra={"algorithm": args.algorithm})
    print(f"checkpoint -> {path}")
    return params


if __name__ == "__main__":
    main()
