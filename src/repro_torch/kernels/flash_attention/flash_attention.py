"""Flash attention: the Hopper CUDA kernels and their plain versions.

The port of ``repro.kernels.flash_attention.flash_attention``: the forward
(``_fwd_kernel``), the backward pair (``_dq_kernel``, ``_dkv_kernel``), the
custom VJP (``_flash_mha``) as a ``torch.autograd.Function`` and the
entry points ``flash_mha`` (differentiable) and ``flash_attention``
(forward only), plus ``ref.attention_ref``'s masked softmax as the plain
forward.

``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` are the wrappers: on
CUDA tensors they launch the kernels of ``csrc/flash_attention/flash_fwd.cu``
and ``flash_bwd.cu`` (built on first use by ``kernels.build``) or raise; on
CPU tensors they run the plain versions. Nothing else selects the path:
there is no fallback from a kernel to its plain version. Each wrapper's
``launches`` counts its kernel launches.

One departure from the JAX package: its backward takes the row term
``D = rowsum(dO ∘ O)`` from the stored bf16 O. O's rounding error then
shifts a whole row of ds = p·(dp − D), and where the true ds is small (the
q/k gradients of trained layers) that shift dominates dQ and dK. Here the
dQ kernel computes ``D = Σ_k p·dp`` from the same f32 p and dp it forms
ds with, and hands D to the dK/dV kernel; the two agree in exact arithmetic.

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
BWD_SOURCE = "flash_attention/flash_bwd.cu"
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
        raise build.KernelLaunchError(f"flash_fwd kernel launch failed: {msg} (cudaError {err})")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def _bad_mask(L, causal, window, device):
    qi = torch.arange(L, device=device)[:, None]
    kj = torch.arange(L, device=device)[None, :]
    bad = torch.zeros((L, L), dtype=torch.bool, device=device)
    if causal:
        bad |= kj > qi
    if window:
        bad |= kj <= qi - window
    return bad


def _check_bwd(q, k, v, lse, do):
    _check(q, k, v)
    if do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"do {tuple(do.shape)}, lse {tuple(lse.shape)} vs q {tuple(q.shape)}")


def _bwd_plain_parts(q, k, v, lse, do, delta, causal, window):
    """Recomputed p = exp(s − lse) (masked → exactly 0), D (the given one,
    or Σ_k p·dp when ``delta`` is None) and ds = p·(dp − D) with
    dp = dO·Vᵀ, in f32, with K/V repeated over the GQA group."""
    B, H, L, dh = q.shape
    group = H // k.shape[1]
    kk = k.to(torch.float32).repeat_interleave(group, dim=1)
    vv = v.to(torch.float32).repeat_interleave(group, dim=1)
    s = torch.einsum("bhld,bhsd->bhls", q.to(torch.float32), kk) * dh**-0.5
    bad = _bad_mask(L, causal, window, q.device)
    p = torch.exp(s - lse[..., None]).masked_fill(bad, 0.0)
    dp = torch.einsum("bhld,bhsd->bhls", do.to(torch.float32), vv)
    if delta is None:
        delta = (p * dp).sum(-1)
    ds = p * (dp - delta[..., None])
    return p, ds, kk, delta


def _group_sum(x, Hkv):
    B, H, L, dh = x.shape
    return x.reshape(B, Hkv, H // Hkv, L, dh).sum(dim=2)


def flash_bwd_dq_plain(q, k, v, lse, do, *, causal=True, window=0):
    """Plain version of the dQ kernel → (dQ = scale · Σ_k ds·K in q.dtype,
    D = Σ_k p·dp in f32 (B, H, L))."""
    dh = q.shape[-1]
    _, ds, kk, delta = _bwd_plain_parts(q, k, v, lse, do, None, causal, window)
    return (torch.einsum("bhls,bhsd->bhld", ds, kk) * dh**-0.5).to(q.dtype), delta


def flash_bwd_dkv_plain(q, k, v, lse, do, delta, *, causal=True, window=0):
    """Plain version of the dK/dV kernel: dV = Σ_q pᵀ·dO and
    dK = scale · Σ_q dsᵀ·Q, summed over the GQA group, in k.dtype."""
    dh = q.shape[-1]
    Hkv = k.shape[1]
    p, ds, _, _ = _bwd_plain_parts(q, k, v, lse, do, delta, causal, window)
    dv = _group_sum(torch.einsum("bhls,bhld->bhsd", p, do.to(torch.float32)), Hkv)
    dk = _group_sum(torch.einsum("bhls,bhld->bhsd", ds, q.to(torch.float32)), Hkv) * dh**-0.5
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, lse, do, *, causal=True, window=0):
    """Plain version of the backward pair → (dQ, dK, dV) in the inputs'
    dtypes."""
    _check_bwd(q, k, v, lse, do)
    dq, delta = flash_bwd_dq_plain(q, k, v, lse, do, causal=causal, window=window)
    dk, dv = flash_bwd_dkv_plain(q, k, v, lse, do, delta, causal=causal, window=window)
    return dq, dk, dv


def _bwd_library():
    from repro_torch.kernels import build

    lib = build.load(BWD_SOURCE)
    for name, n_ptr in (("flash_bwd_dq_bf16", 7), ("flash_bwd_dkv_bf16", 8)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(name, q, k, v, do, lse, delta, dh, window):
    """``delta`` is None for the dQ kernel, which computes D itself."""
    rows = (lse,) if delta is None else (lse, delta)
    if any(t.dtype not in KERNEL_DTYPES for t in (q, k, v, do)) or \
            any(t.dtype != torch.float32 for t in rows):
        raise TypeError(f"{name} kernel takes q, k, v, dO in {KERNEL_DTYPES} and lse, D in "
                        f"float32, got {[t.dtype for t in (q, k, v, do, *rows)]}")
    if do.shape != q.shape or any(t.shape != q.shape[:3] for t in rows):
        raise ValueError(f"{name}: do {tuple(do.shape)}, lse/D {[tuple(t.shape) for t in rows]} "
                         f"vs q {tuple(q.shape)}")
    tensors = (q, k, v, do, *rows)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} kernel needs 16-byte aligned inputs")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel is built for head dims {KERNEL_HEAD_DIMS}, got {dh}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_bwd_dq(q, k, v, lse, do, *, causal=True, window=0):
    """dQ of flash attention (q.dtype) and D = Σ_k p·(dO·v) (f32, B×H×L),
    the row term the dK/dV kernel takes. CUDA tensors launch the Hopper dQ
    kernel (bf16 q/k/v/dO, f32 lse, contiguous, dh ∈ {64, 128}); CPU
    tensors run ``flash_bwd_dq_plain``."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, lse, do, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: unsupported device {q.device}")
    _check(q, k, v)
    B, H, L, dh = q.shape
    _check_kernel_inputs("flash_bwd_dq", q, k, v, do, lse, None, dh, window)
    lib = _bwd_library()
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_bwd_dq_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H,
                                k.shape[1], L, dh, int(bool(causal)), int(window), stream)
    if err != 0:
        msg = lib.flash_bwd_error_string(err).decode()
        raise build.KernelLaunchError(
            f"flash_bwd_dq kernel launch failed: {msg} (cudaError {err})")
    flash_bwd_dq.launches += 1
    return dq, delta


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, lse, do, delta, *, causal=True, window=0):
    """(dK, dV) of flash attention (k.dtype), summed over each GQA group
    inside the kernel (no atomics: deterministic). CUDA tensors launch the
    Hopper dK/dV kernel; CPU tensors run ``flash_bwd_dkv_plain``."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, lse, do, delta, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: unsupported device {q.device}")
    _check(q, k, v)
    B, H, L, dh = q.shape
    _check_kernel_inputs("flash_bwd_dkv", q, k, v, do, lse, delta, dh, window)
    lib = _bwd_library()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_bwd_dkv_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                 B, H, k.shape[1], L, dh, int(bool(causal)), int(window), stream)
    if err != 0:
        msg = lib.flash_bwd_error_string(err).decode()
        raise build.KernelLaunchError(
            f"flash_bwd_dkv kernel launch failed: {msg} (cudaError {err})")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd(q, k, v, lse, do, *, causal=True, window=0):
    """Backward of flash attention → (dQ, dK, dV) in the inputs' dtypes: the
    dQ kernel (which also yields D), then the dK/dV kernel (or their plain
    versions on the CPU)."""
    _check_bwd(q, k, v, lse, do)
    dq, delta = flash_bwd_dq(q, k, v, lse, do, causal=causal, window=window)
    dk, dv = flash_bwd_dkv(q, k, v, lse, do, delta, causal=causal, window=window)
    return dq, dk, dv


class FlashMHA(torch.autograd.Function):
    """The custom VJP of ``_flash_mha``: forward saves (q, k, v, LSE);
    backward recomputes the probabilities from LSE in the backward pair.
    Unlike the JAX VJP it needs no O: D = Σ_k p·dp is taken in the dQ
    kernel rather than as rowsum(dO ∘ O) over the bf16-rounded O."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, lse, do.contiguous(), causal=ctx.causal,
                               window=ctx.window)
        return dq, dk, dv, None, None


def flash_mha(q, k, v, *, causal=True, window=0):
    """Differentiable flash attention (the training/prefill entry point):
    q (B, H, L, dh), k/v (B, Hkv, L, dh) → O (B, H, L, dh) in q.dtype. Any
    L: the kernels mask the ragged edge, nothing is padded."""
    return FlashMHA.apply(q, k, v, bool(causal), int(window))


def flash_attention(q, k, v, *, causal=True, window=0):
    """Forward-only entry point (the JAX package's ``flash_attention``):
    returns O only."""
    return flash_fwd(q, k, v, causal=causal, window=window)[0]
