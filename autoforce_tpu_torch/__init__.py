"""autoforce_tpu_torch — the PyTorch/CUDA port of autoforce_tpu.

Serves a trained sparse-GP (SGPR) SOAP force field through device-resident
molecular dynamics on an NVIDIA GPU.  The SOAP expansion coefficients and
their gradient run in hand-written CUDA kernels (``csrc/soap_coeff.cu``);
everything around them is plain torch.  Module names mirror the JAX
package ``autoforce_tpu`` so each piece can be found beside its reference.

The package never imports JAX or ``autoforce_tpu``.
"""

import os as _os

import torch as _torch

__version__ = "0.1.0"

# Full float32 matmuls and convolutions.  TF32 keeps ~3 decimal digits,
# which pushes normalized kernel values above 1, zeroes the covloss
# sampling signal and degrades forces to percent level (the counterpart
# of the bf16-matmul failure the JAX package pins away).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

# Kernels and the native cell list are compiled here at first use.
BUILD_DIR = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "_build")


def resolve_device(device="cuda"):
    """``torch.device`` for an entry point; raises when a CUDA device is
    asked for and none is present (never falls back to the CPU)."""
    device = _torch.device(device)
    if device.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return device


from . import units  # noqa: E402
from .system import SinglePointCalculator, System  # noqa: E402

__all__ = ["units", "System", "SinglePointCalculator", "resolve_device",
           "BUILD_DIR", "__version__"]
