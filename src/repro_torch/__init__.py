"""PyTorch / CUDA port of ``repro``: cost-driven offloading of DNN layers
over cloud / edge / end devices via PSO-GA (Lin et al., 2019), planned on
an NVIDIA GPU.

The layout mirrors the JAX package (``core/``, ``kernels/``, ``configs/``,
``launch/``) so each module's counterpart is easy to find. Nothing here
imports ``jax`` or ``repro``: the numpy-only modules the port needs are
copied. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
