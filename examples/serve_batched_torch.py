"""Serve a small model on the PyTorch port with batched requests: prefill + greedy decode.

    PYTHONPATH=src python examples/serve_batched_torch.py --arch mamba2-2.7b
    PYTHONPATH=src python examples/serve_batched_torch.py --arch gemma-2b --new 24
    PYTHONPATH=src python examples/serve_batched_torch.py --arch gemma-2b --cpu

The counterpart of ``examples/serve_batched.py``, with its flags: the
reduced same-family model of ``--arch`` (``reduced(ARCHS[arch])``: 2 layers,
d_model 256) in float32 with random weights from a seed, attention and the
SSD scan on the plain ``attn_impl="dense"`` path (dense softmax; the
chunked SSD for a Mamba2 layer), and greedy ``ServeEngine.generate``.  It
runs on the card unless ``--cpu`` asks for the CPU, and refuses an audio
arch (an encoder-decoder is served through ``ServeEngine(is_encdec=True)``'s
two steps).
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.launch import ServeEngine  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402


def main(argv=None) -> torch.Tensor:
    """Serve one batch of requests; return the (batch, new) generated tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    cfg = reduced(ARCHS[args.arch])
    if cfg.arch_type == "audio":
        raise SystemExit("use a decoder arch for this example")
    dev = torch.device("cpu" if args.cpu else "cuda")
    model = DecoderLM(cfg, dtype=torch.float32, attn_impl="dense", remat=False, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model)

    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    cache_len = args.prompt_len + args.new

    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new=args.new, cache_len=cache_len)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = args.batch * args.new
    print(f"arch={args.arch} ({cfg.arch_type}, reduced)  batch={args.batch}  "
          f"prompt={args.prompt_len}  new={args.new}")
    print(f"generated {toks} tokens in {dt:.2f}s  ({toks / dt:.1f} tok/s on {dev.type})")
    for i in range(min(2, args.batch)):
        print(f"  req{i}: ...{prompts[i, -4:].tolist()} -> {out[i].tolist()}")
    return out


if __name__ == "__main__":
    main()
