"""Device resolution for the PyTorch port.

The counterpart of the JAX package's backend probing (``utils/hw.py``,
``jax_compat.py``): every entry point of this package (``DecodeEngine``,
the model constructors, ``chip_smoke.py``) runs on the CUDA card unless the
caller asks for the CPU by passing ``device="cpu"``. With no card and no
explicit CPU request they raise — nothing carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card. A CPU device is returned only when it
    was asked for explicitly; a CUDA request without a card raises."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         f"'cpu'")
    return dev


def device_report() -> Dict[str, Any]:
    """``{"platform": "gpu", "kind": <card name>, "count": n}`` for the CUDA
    cards of this process; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def as_dtype(dtype: Optional[Any]) -> Optional[torch.dtype]:
    """Accept ``None``, a ``torch.dtype`` or a name (``"bfloat16"``,
    ``"bf16"``, ``"float32"``, ``"f32"``) for the compute dtype — the two
    types the port's kernels take."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    names = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
             "f32": torch.float32, "float32": torch.float32}
    key = str(dtype).lower().replace("torch.", "")
    if key not in names:
        raise ValueError(f"unsupported compute dtype {dtype!r}")
    return names[key]
