"""Device and precision policy of the port.

The counterpart of the JAX package's ``design._PREC`` (every model
contraction at full float32): the port computes in float32 everywhere,
and TF32 is switched off for matrix products and convolutions alike, so
a float32 product on the card keeps all 24 mantissa bits.

Time maps stay HOST numpy float64: absolute epoch days (~2e4) quantize
to ~5 minutes in float32, so every ``ds - ds_start`` subtraction happens
on the host in float64 and only the O(1) result is cast and shipped.

Entry points take ``device=None`` and resolve it to ``"cuda"``.  Without
a card they raise; nothing here falls back to the CPU.  Tests ask for
the CPU explicitly with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DTYPE = torch.float32


def set_precision() -> None:
    """Full float32 for every product: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card.  A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    set_precision()
    return dev
