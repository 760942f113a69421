"""Device resolution shared by every entry point of the port.

Entry points default to ``device="cuda"`` and raise when no card is
present: the port never falls back to the CPU on its own. The CPU runs
only when a caller asks for it (the tests do), and then every kernel
wrapper takes its plain PyTorch version. ``meta`` holds shapes and no data
(``Model.init(device="meta")`` checks a full-size configuration's tree).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' explicitly to run the plain versions")
        # Precision: float32 products stay float32 (no TF32 in matmuls or
        # cuDNN convolutions), and bf16 GEMMs reduce in float32 — the JAX
        # package's ``preferred_element_type=float32`` contract.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r} (cuda | cpu | meta)")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` string → torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
