"""PyTorch + CUDA port of `unislam_tpu` for NVIDIA Hopper (H100).

Same layout as the JAX package (`core/`, `models/`, `render/`, `engine/`,
`data/`), plain functions on tensors, explicit devices and generators. The
hot operations are hand-written CUDA kernels under `csrc/`, built with nvcc
at first use (`kernels/build.py`); each has a plain PyTorch version beside
it, which is what runs for tensors on the CPU.

Precision: TF32 is switched off for matmuls and cuDNN when the package is
imported, so f32 products on the card stay f32 like the JAX reference's.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is wanted but absent (no silent CPU run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
