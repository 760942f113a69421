"""Shared neural-net layers, the port of ``repro.models.layers``.

Numeric discipline (paper §2.1 "mixed-precision GEMM"): params/activations
are stored in the policy dtype (bf16); every matmul accumulates in fp32 and
is rounded back to the storage dtype; norms/softmax run in fp32.

On a grid of ranks (``distributed.sharding.make_activation_sharder``,
installed by ``models.transformer.activation_sharding``) the layers read
this rank's blocks: the MLP's ``w_gate``/``w_up``/``w_in`` are column
blocks and ``w_down``/``w_out`` row blocks, so ``mlp_apply`` leaves a
partial sum that the sublayer's boundary sums over "model"; an embedding
table of a vocab block is looked up vocab-parallel (``embed_lookup``).
"""

from __future__ import annotations

import contextvars

import torch
import torch.nn.functional as F

ACC = torch.float32  # f32-ok: accumulation dtype (GEMM outputs, norms, softmax)

# the grid's activation sharder of the running forward (None off a grid)
SHARDER = contextvars.ContextVar("repro_torch_sharder", default=None)


def sharder():
    return SHARDER.get()


def check_write(what: str, value, target_shape):
    """Raise ``ValueError`` unless an in-place cache or state write's value
    has its target's shape. The write would broadcast a dim of one and, on
    the meta device (a dry run), take any shape unchecked: with this check
    every device refuses what the CPU refuses. On a grid a sublayer must
    hold this rank's block of the heads or channels that
    ``cache_shardings`` splits over "model" (served from
    ``distributed.sharding.materialize_serving``)."""
    got, want = tuple(value.shape), tuple(target_shape)
    if got != want:
        raise ValueError(f"{what}: a write of {got} into a cache slot of {want}: the sublayer's "
                         f"heads or channels are not its cache's")


def chunk_pad(length: int, chunk: int) -> tuple[int, int]:
    """(chunk, right-pad) so chunked causal mixers handle arbitrary
    (serving) lengths: pad the sequence up to a chunk multiple and slice the
    tail off the output — valid positions are unaffected (causal), and
    multiples keep the configured chunk so training numerics are
    unchanged. Never shrinks the chunk (a prime length must not degrade to
    a token-by-token scan)."""
    c = min(chunk, length)
    return c, (-length) % c


def dense_init(gen, shape, dtype, scale=None):
    """N(0, 1) · scale, drawn in f32 on ``gen``'s device; ``shape`` ends in
    (d_in, d_out) and may lead with a stack axis. Default scale d_in^-1/2."""
    scale = scale if scale is not None else shape[-2] ** -0.5
    if gen.device.type == "meta":                    # shapes only
        return torch.empty(shape, dtype=dtype, device="meta")
    # f32-ok: init draws in f32, then casts to the parameter dtype
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * scale).to(dtype)


def rms_norm_init(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)  # (1 + scale) parameterization


def matmul(x, w):
    """Storage-dtype matmul with fp32 accumulation. A bf16 GEMM reduces in
    fp32 and rounds once to bf16 (``device.resolve_device`` turns off the
    reduced-precision split-K reduction on the card)."""
    return torch.matmul(x, w)


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of two storage-dtype operands, 2-D (mm) or batched 3-D
    (bmm), with an f32 result: one tensor-core product with f32 output
    (``aten::mm.dtype`` / ``bmm.dtype``, which have no derivative of their
    own). The backward is JAX's transpose rule for ``dot_general`` with
    ``preferred_element_type=f32``: each operand's cotangent is a product
    of the f32 cotangent g with the other operand, f32 out, converted to
    the operand's dtype. g is rounded to the operands' dtype for those two
    products (a TPU's default precision does the same to an f32 operand of
    a bf16 product). With ``out_dtype`` the f32 result is rounded once to
    it, and the cotangent arrives in that dtype: not widened to f32 by the
    cast's backward only to be rounded back here."""

    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        out = _mm_f32(a, b)
        return out if out_dtype is None else out.to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = _mm_f32(g, b.transpose(-1, -2)).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = _mm_f32(a.transpose(-1, -2), g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db, None


def _mm_f32(a, b):
    mm = torch.mm if a.dim() == 2 else torch.bmm
    return mm(a, b, out_dtype=ACC)


def matmul_f32(a, b, out_dtype=None):
    """``a @ b`` (2-D, or 3-D batched) with an f32 result: the JAX
    package's ``preferred_element_type=f32`` product, rounded once to
    ``out_dtype`` if one is given (its ``.astype``). On the card a bf16
    pair runs as one bf16 product with f32 output (``_MatmulF32``). The
    CPU has no ``mm.dtype`` kernel, so there (and for f32 operands) both
    operands are upcast and multiplied in f32: the same products, summed
    in another order. A dry run's meta tensors take the card's path."""
    if a.device.type in ("cuda", "meta") and a.dtype != ACC:
        return _MatmulF32.apply(a, b, out_dtype)
    out = torch.matmul(a.to(ACC), b.to(ACC))
    return out if out_dtype is None else out.to(out_dtype)


def out_proj(x, w, whole_rows=None):
    """``matmul(x, w)`` into the residual stream. On a grid, a row block of
    ``w`` (fewer than ``whole_rows`` rows: a row-parallel product) gives its
    f32 partial product, which the sublayer sums over "model" in f32 and
    rounds once, as one rank rounds the whole product once."""
    if SHARDER.get() is None or whole_rows is None or w.shape[-2] == whole_rows:
        return matmul(x, w)
    y = matmul_f32(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def rms_norm(x, scale, eps):
    xf = x.to(ACC)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(ACC))).to(x.dtype)


def embed_lookup(table, ids, vocab_size=None):
    """``table[ids]``; on a grid, a table of ``vocab_size`` rows split over
    "model" is looked up vocab-parallel: ids outside this rank's rows read
    zeros, then Σ over "model"."""
    sh = SHARDER.get()
    if sh is not None and vocab_size is not None and table.shape[0] < vocab_size:
        return sh.embed(table, ids)
    return table[ids]


# ----------------------------------------------------------------- RoPE ----
def rope_freqs(positions, head_dim, theta):
    """positions: (..., L) int → cos/sin (..., L, head_dim/2), f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=ACC, device=positions.device) / head_dim
    inv = 1.0 / (theta**exponent)
    ang = positions.to(ACC)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope_apply(x, cos, sin):
    """x: (B, L, H, dh); cos/sin: (B, L, dh/2) — rotate split halves."""
    xf = x.to(ACC)
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ MLP ----
def mlp_apply(p, x, act, d_ff=None):
    if act == "swiglu":
        g = matmul(x, p["w_gate"])
        u = matmul(x, p["w_up"])
        h = (F.silu(g.to(ACC)) * u.to(ACC)).to(x.dtype)
        return out_proj(h, p["w_down"], d_ff)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(matmul(x, p["w_in"]).to(ACC), approximate="tanh").to(x.dtype)
    return out_proj(h, p["w_out"], d_ff)
