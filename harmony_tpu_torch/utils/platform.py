"""Device selection, operator knobs and the kernel route.

Counterpart of ``harmony_tpu/utils/platform.py``. The port runs on the card
unless the caller asks for the CPU: :func:`resolve_device` turns a request into
a ``torch.device`` and raises when the card is asked for and there is none,
never moving to the CPU quietly. :func:`use_kernel` is the one place a kernel
wrapper decides its route: a CUDA tensor launches the hand-written kernel, a
CPU tensor takes the plain PyTorch version. :func:`peak_bf16_flops` is the
card's dense bf16 peak, the tenant ledger's MFU denominator.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_WARNED_ENV: set = set()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card. Raises when the card
    is asked for and PyTorch sees none: a CPU run must be asked for
    (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) to "
            "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on the card (launch the kernel), False when they
    lie on the CPU (plain version). Tensors on different devices, or on another
    device type, raise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {dev}")


#: Dense (no sparsity) peak bf16 FLOP/s of one card, by a substring of
#: ``torch.cuda.get_device_name``: "NVIDIA H100 80GB HBM3" (the SXM part)
#: 989 TFLOP/s, NVIDIA's data sheet at the card's full 700 W power limit.
_PEAK_BF16 = (
    ("h100 80gb hbm3", 989e12),
)


def peak_bf16_flops() -> Optional[float]:
    """The dense peak bf16 FLOP/s of the current card, or None without a card
    or for a card the table does not name. Reads the card's name only: no
    kernel, no sync."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name().lower()
    for sub, peak in _PEAK_BF16:
        if sub in name:
            return peak
    return None


def full_f32_matmuls() -> None:
    """Float32 products in full float32 on the card, as the reference computes
    them on the CPU (and at HIGHEST precision on the TPU): TF32 keeps ~10
    mantissa bits. This is PyTorch's default; the entry points that run f32
    products (the worker, ViT's train step, generation) set it, not assume it."""
    torch.backends.cuda.matmul.allow_tf32 = False


def hard_sync(tree: Any) -> Any:
    """Wait for the device work that produced the tensors in ``tree`` (a
    tensor, or tuples, lists and dicts of them): the current stream of each
    card they lie on is synchronised. CPU tensors are ready already. Returns
    ``tree``."""
    devices = set()

    def visit(x: Any) -> None:
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                visit(v)

    visit(tree)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return tree


def env_choice(var: str, allowed: tuple) -> Optional[str]:
    """Value of env ``var`` when it is one of ``allowed``, else None — warning
    ONCE about unrecognized non-empty values. These vars are operator rollback
    knobs; a typo silently falling through to the default would leave the
    operator believing a rollback is in effect."""
    val = os.environ.get(var)
    if not val:
        return None
    if val in allowed:
        return val
    if var not in _WARNED_ENV:
        _WARNED_ENV.add(var)
        logging.getLogger(__name__).warning(
            "%s=%r is not one of %s — IGNORED, default route stays active",
            var, val, list(allowed),
        )
    return None
