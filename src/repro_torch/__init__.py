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
- ``repro_torch.fedsim``   — the M-client federated simulation (the scan,
  eager and streamed round loops of ``FederatedSession``, the cohort split
  over a ``torch.distributed`` client mesh by ``ShardSpec``).
- ``repro_torch.kernels``  — hand-written CUDA kernels for Hopper
  (dp_aggregate, flash_attention, ssd_scan) with plain PyTorch versions
  beside them.
- ``repro_torch.data``     — the paper's synthetic linear regression, the
  generated image set and per-client token streams.
- ``repro_torch.configs``  — the architecture registry (a copy of the JAX
  package's dataclasses).
- ``repro_torch.models``   — the model zoo: the paper's CNNs, the dense, MoE,
  Mamba2, hybrid and VLM decoder LMs (``DecoderLM``) and whisper's
  encoder-decoder (``EncDecLM``), trainable through plain attention paths;
  the logical-axis rules of the client mesh.
- ``repro_torch.launch``   — serving (``ServeEngine``), federated LM
  training (``FederatedTrainer``) and the client mesh.
- ``repro_torch.telemetry`` — round trackers and the engine tap.
The launch specs, the parameter sharding rules, the production meshes and
the dry-run tools are still to port (ROADMAP.md).
"""

__version__ = "0.1.0"
