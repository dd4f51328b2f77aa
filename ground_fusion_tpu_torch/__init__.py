"""ground_fusion_tpu_torch — the PyTorch/CUDA port of the ground-SLAM engine.

The package mirrors the layout of the JAX package module by module, imports
``torch`` and numpy only, and keeps its tensors on the GPU: every entry point
takes ``device=None`` meaning ``cuda`` and raises when no card is present;
the CPU is used only when the caller asks for it by name.

On import, float32 arithmetic is pinned to full precision and checked: the
estimator's normal-equation pipeline ``H = JᵀJ`` → Schur → Cholesky carries
``sqrt_info``-scaled Hessian diagonals of ~1e7, and reduced-precision
products (TF32 keeps a 10-bit mantissa) leave rounding errors far above any
safe ridge, so the marginalization Cholesky goes indefinite. cuDNN
convolutions use TF32 by default, so that switch is turned off as well.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

assert not _torch.backends.cuda.matmul.allow_tf32
assert not _torch.backends.cudnn.allow_tf32
assert _torch.get_float32_matmul_precision() == "highest"


def resolve_device(device=None) -> "_torch.device":
    """``None`` means the GPU; without one this raises instead of silently
    running on the CPU. Pass ``"cpu"`` to run on the CPU on purpose."""
    if device is None:
        if not _torch.cuda.is_available():
            raise RuntimeError(
                "ground_fusion_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return _torch.device("cuda", _torch.cuda.current_device())
    device = _torch.device(device)
    if device.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was requested but none is available")
    return device
