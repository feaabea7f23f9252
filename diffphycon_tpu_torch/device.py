"""Device selection: CUDA unless the caller names another device."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA request without CUDA raises.

    There is no silent fallback to the CPU: callers that want the CPU (the
    tests, small runs) pass ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by default; "
            "pass device='cpu' to run on the CPU")
    return dev


def fp32_convs() -> None:
    """Run cuDNN convolutions in full fp32, forward and backward, as XLA runs
    the JAX nets' convolutions.

    PyTorch lets cuDNN compute a float32 convolution in TF32 by default. A
    ``cudnn.flags(allow_tf32=False)`` context around a forward does not reach
    its backward: autograd runs a convolution's backward (and a checkpointed
    block's recompute) after the context has closed, and reads the
    process-wide flag then. So every net of the port clears that flag for the
    process when its forward starts.
    """
    torch.backends.cudnn.allow_tf32 = False
