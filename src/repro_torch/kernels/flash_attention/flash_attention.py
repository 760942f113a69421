"""Flash-attention forward: the Hopper CUDA kernel and its plain version.

The port of ``repro.kernels.flash_attention.flash_attention``'s forward
half (``_fwd_kernel`` / ``_fwd_call`` / ``flash_mha`` forward /
``flash_attention``) and of ``ref.attention_ref``. Serving runs only the
forward pass; the backward kernels (``_dq_kernel``, ``_dkv_kernel``) come
with the training slice.

``flash_fwd`` is the wrapper: on a CUDA tensor it launches the kernel of
``csrc/flash_attention/flash_fwd.cu`` (built on first use by
``kernels.build``) or raises; on a CPU tensor it runs ``flash_fwd_plain``.
Nothing else selects the path: there is no fallback from the kernel to the
plain version. ``flash_fwd.launches`` counts kernel launches.

Conventions (as the JAX kernel's): q (B, H, L, dh), k/v (B, Hkv, L, dh)
with H % Hkv == 0 (GQA: kv head = h // (H / Hkv), K/V are never
replicated); ``window`` > 0 keeps kpos ∈ (qpos − window, qpos]; O comes back
in q.dtype and the row log-sum-exp in f32, with +1e30 for a row that no key
reaches. Any L: the kernel masks the ragged edge itself, so nothing is
padded to a block multiple.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
KERNEL_SOURCE = "flash_attention/flash_fwd.cu"
KERNEL_DTYPES = (torch.bfloat16,)
KERNEL_HEAD_DIMS = (64, 128)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, H, L, dh): {q.shape}, {k.shape}, {v.shape}")
    B, H, L, dh = q.shape
    Hkv = k.shape[1]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    if k.shape != (B, Hkv, L, dh) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v of different dtypes: {q.dtype}, {k.dtype}, {v.dtype}")


def flash_fwd_plain(q, k, v, *, causal=True, window=0):
    """Masked full softmax in f32: the plain version of the kernel, with its
    conventions. Returns (O in q.dtype, LSE (B, H, L) f32)."""
    _check(q, k, v)
    B, H, L, dh = q.shape
    group = H // k.shape[1]
    kk = k.to(torch.float32).repeat_interleave(group, dim=1)
    vv = v.to(torch.float32).repeat_interleave(group, dim=1)
    s = torch.einsum("bhld,bhsd->bhls", q.to(torch.float32), kk) * dh**-0.5
    qi = torch.arange(L, device=q.device)[:, None]
    kj = torch.arange(L, device=q.device)[None, :]
    bad = torch.zeros((L, L), dtype=torch.bool, device=q.device)
    if causal:
        bad |= kj > qi
    if window:
        bad |= kj <= qi - window
    s = s.masked_fill(bad, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(bad, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhls,bhsd->bhld", p / l.clamp_min(1e-30), vv).to(q.dtype)
    m, l = m[..., 0], l[..., 0]
    lse = torch.where(m > NEG_INF * 0.5, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(m, -NEG_INF))
    return o, lse


def _library():
    from repro_torch.kernels import build

    lib = build.load(KERNEL_SOURCE)
    fn = lib.flash_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def flash_fwd(q, k, v, *, causal=True, window=0):
    """Flash-attention forward → (O, LSE). CUDA tensors launch the Hopper
    kernel (bf16, contiguous, dh ∈ {64, 128}; anything else raises); CPU
    tensors run ``flash_fwd_plain``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash_fwd kernel takes {KERNEL_DTYPES}, got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd kernel needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd kernel needs 16-byte aligned q, k, v (it loads 8 bf16 at once)")
    B, H, L, dh = q.shape
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel is built for head dims {KERNEL_HEAD_DIMS}, got {dh}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    lib = _library()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                             lse.data_ptr(), B, H, k.shape[1], L, dh, int(bool(causal)),
                             int(window), stream)
    if err != 0:
        msg = lib.flash_fwd_error_string(err).decode()
        raise RuntimeError(f"flash_fwd kernel launch failed: {msg} (cudaError {err})")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_attention(q, k, v, *, causal=True, window=0):
    """Forward-only entry point (the JAX package's ``flash_attention``):
    returns O only."""
    return flash_fwd(q, k, v, causal=causal, window=window)[0]
