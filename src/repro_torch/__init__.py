"""repro_torch — the PyTorch and CUDA port of the DP-FedEXP framework ``repro``.

Paper: "Accelerating Differentially Private Federated Learning via Adaptive
Extrapolation" (Takakura, Liew, Hasegawa, 2025).  The JAX package ``repro``
is the reference; this package imports nothing of it, and tests hold each
ported module against its counterpart there.  Entry points run on the CUDA
card unless the caller asks for the CPU.

Layers
------
- ``repro_torch.core``     — the paper's contribution: DP mechanisms, adaptive
  global step-size rules (LDP/CDP-FedEXP), clipping, privacy accounting.
- ``repro_torch.optim``    — server optimizers (SGD, momentum, Adam) over
  pseudo-gradients.
- ``repro_torch.fedsim``   — the M-client federated simulation (the eager and
  streamed round loops of ``FederatedSession``).
- ``repro_torch.kernels``  — hand-written CUDA kernels for Hopper
  (dp_aggregate, flash_attention, ssd_scan) with plain PyTorch versions
  beside them.
- ``repro_torch.data``     — the paper's synthetic linear regression, the
  generated image set and per-client token streams.
- ``repro_torch.configs``  — the architecture registry (a copy of the JAX
  package's dataclasses).
- ``repro_torch.models``   — the model zoo: the paper's CNNs and dense and
  Mamba2 decoder LMs (``DecoderLM``), trainable through plain attention paths.
- ``repro_torch.launch``   — serving (``ServeEngine``) and federated LM
  training (``FederatedTrainer``).
- ``repro_torch.telemetry`` — round trackers.
MoE, hybrid and enc-dec models, sharding and the engine tap are still to
port (ROADMAP.md).
"""

__version__ = "0.1.0"
