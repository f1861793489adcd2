"""Device selection: the port runs on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and absent.

    There is no silent fallback: a caller that wants the CPU says so.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def kernel_dtype(device, compute_dtype) -> torch.dtype:
    """The dtype of a hand-written kernel's operands on ``device``: bf16 on the
    card, the only dtype the trunk, one-block and FF kernels read; on the CPU
    the module's compute dtype, in which their plain versions run. A float32
    module casts at the kernel call and takes the result back in float32."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else compute_dtype


def randn(shape, generator, device, dtype=torch.float32) -> torch.Tensor:
    """A standard normal draw from an explicit generator.

    Every random draw of the port goes through an explicit
    ``torch.Generator`` (or is injected by the caller); a missing generator
    is an error rather than a draw from the global RNG.
    """
    if generator is None:
        raise ValueError(
            "this draw needs a torch.Generator (or pass the tensor to inject)"
        )
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)
