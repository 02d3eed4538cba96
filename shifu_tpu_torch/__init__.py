"""shifu_tpu_torch — the PyTorch/CUDA port of shifu_tpu, for one NVIDIA H100.

The JAX package `shifu_tpu` is the reference; this package keeps its
module names and public layouts so each module can be held against its
counterpart. It imports `torch` and never `jax`, and nothing of
`shifu_tpu`: the few jax-free helpers it needs are copied in.

Routing has no knob. A function that owns a hand-written kernel
launches that kernel for CUDA tensors (or raises) and runs its plain
PyTorch version only for CPU tensors. Entry points (`Scorer`,
`ScorerService`, the CLI) default to ``device="cuda"`` and raise when no
card is present; tests pass ``device="cpu"`` explicitly.

Importing the package turns TF32 off for matmuls and cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``): the NN's later layers are
plain f32 ``torch.matmul``, and TF32 would cost three digits there.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]


def resolve_device(device: "str | torch.device") -> torch.device:
    """`device` as a torch.device; a CUDA device with no card present
    raises — the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA "
            "device; pass device='cpu' to run the plain PyTorch route")
    return dev
