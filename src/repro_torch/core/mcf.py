"""Multi-Component Float (MCF) arithmetic, the port of ``repro.core.mcf``:
the error-free transformations of Paper §4.1 / Appendix C over length-2
expansions ``(hi, lo)`` (``hi + lo`` the unevaluated exact sum).

Strict FPU: all arithmetic runs in f32 "registers" and is rounded to
nearest-even onto the component grid after every operation
(``rn(x) = x.to(dtype).float()``, bitwise equal to the JAX package's
``lax.reduce_precision``). Eager PyTorch rounds every op separately and
never contracts a multiply and an add into an FMA, so these functions are
bit-identical to the JAX ones; ``torch.compile`` must not be put over them
(a fused FMA erases the roundoff the transformations keep).

The two fp8 formats of gradient compression (``float8_e4m3fn`` and
``float8_e5m2``) round as ``lax.reduce_precision`` with (exponent,
mantissa) bits (4, 3) and (5, 2) does: ``_reduce_precision`` is that
function on the f32 bit pattern, so the e4m3 grid tops out at 240 (not
e4m3fn's storage maximum 448), values past the grid's rounding edge become
±inf and the grid's subnormals are flushed to zero. ``x.to(float8_e4m3fn)``
is not that function (it keeps subnormals and gives NaN past 448); it is
used only to store a value already on the grid.

``stochastic_round`` takes its random bits as an argument: the JAX package
draws them from a threefry key, which the port cannot reproduce; its
callers draw them from the counter-based stream of ``core.bucketing``
(``sr_bits32``), the same on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bucketing
from repro_torch.core.bucketing import MASK32

F32 = torch.float32  # f32-ok: MCF emulation scratch, every op rounded on its own

# significand bits (incl. hidden bit) and minimum normal exponent
# f32-ok: format tables (this and the next)
_SIG_BITS = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24,
             torch.float8_e4m3fn: 4, torch.float8_e5m2: 3}
_EMIN = {torch.bfloat16: -126, torch.float16: -14, torch.float32: -126,  # f32-ok
         torch.float8_e4m3fn: -6, torch.float8_e5m2: -14}
# (exponent bits, mantissa bits) of the formats rounded by ``_reduce_precision``
_FP8_FMT = {torch.float8_e4m3fn: (4, 3), torch.float8_e5m2: (5, 2)}


def _reduce_precision(x32, eb: int, mb: int):
    """``lax.reduce_precision(x32, eb, mb)`` on the f32 bit pattern: round
    the mantissa to ``mb`` bits (nearest, ties to even), then send exponents
    above the format's largest to ±inf and those at or below its smallest
    normal's predecessor to ±0; NaN stays NaN. uint32 arithmetic in int64
    masked to 32 bits."""
    xi = x32.contiguous().view(torch.int32).to(torch.int64) & MASK32
    shift = 23 - mb
    last = 1 << shift
    bias = ((xi & last) >> shift) + ((last >> 1) - 1)
    xi = ((xi + bias) & MASK32) & (~(last - 1) & MASK32)
    ebias = (1 << (eb - 1)) - 1
    exp = xi & 0x7F800000
    sign = xi & 0x80000000
    xi = torch.where(exp > ((127 + ebias) << 23), sign | 0x7F800000, xi)
    xi = torch.where(exp <= ((127 - ebias) << 23), sign, xi)
    out = torch.where(xi >= 2**31, xi - 2**32, xi).to(torch.int32).view(F32)
    return torch.where(torch.isnan(x32), x32, out)


class StrictFPU:
    """Correctly-rounded low-precision FPU emulated in f32 registers. Values
    are f32 tensors lying exactly on the target grid; ``load``/``store``
    convert to and from the storage dtype (both exact)."""

    def __init__(self, dtype):
        if dtype not in _SIG_BITS:
            raise TypeError(f"StrictFPU: unsupported component dtype {dtype}")
        self.dtype = dtype

    def rn(self, x32):
        """Round-to-nearest-even onto the target grid (stays f32)."""
        if self.dtype in _FP8_FMT:
            return _reduce_precision(x32.to(F32), *_FP8_FMT[self.dtype])
        return x32.to(self.dtype).to(F32)

    def load(self, x):
        return x.to(F32)

    def store(self, x32):
        return x32.to(self.dtype)          # exact: x32 is on-grid

    def round(self, x32):
        """``store(rn(x32))`` in one rounding: the RN value in the storage
        dtype, with no widening and narrowing again of the rounded value."""
        if self.dtype in _FP8_FMT:
            return self.store(self.rn(x32))
        return x32.to(self.dtype)

    def cast(self, x32):
        return self.rn(x32)

    def add(self, a, b):
        return self.rn(a + b)

    def sub(self, a, b):
        return self.rn(a - b)

    def mul(self, a, b):
        return self.rn(a * b)

    def div(self, a, b):
        return self.rn(a / b)


def sqrt_rn(x32):
    """Correctly rounded f32 square root. torch's vectorised CPU ``sqrt`` is
    not (one ulp off on some inputs, where XLA's, numpy's and CUDA's
    ``__fsqrt_rn`` are exact); a square root taken in f64 and rounded once to
    f32 is correctly rounded (53 ≥ 2·24 + 2 bits)."""
    return torch.sqrt(x32.to(torch.float64)).to(F32)  # f32-ok: sqrt in f64, rounded once


def fpu(dtype) -> StrictFPU:
    return StrictFPU(dtype)


@dataclasses.dataclass(frozen=True)
class Expansion:
    """Length-2 MCF expansion: unevaluated sum ``hi + lo`` (Def. 2.1)."""

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def shape(self):
        return self.hi.shape

    def value(self, dtype=F32):
        """Evaluate the expansion in a wider dtype."""
        return self.hi.to(dtype) + self.lo.to(dtype)


def zeros_like_expansion(x) -> Expansion:
    return Expansion(x, torch.zeros_like(x))


def fast2sum(a, b):
    """Dekker's Fast2Sum (Thm 4.1), |a| ≥ |b|: x = RN(a+b), x + y == a + b."""
    f = fpu(a.dtype)
    a32, b32 = f.load(a), f.load(b)
    x16 = f.round(a32 + b32)
    x = f.load(x16)
    return x16, f.round(b32 - f.sub(x, a32))


def two_sum(a, b):
    """Knuth's TwoSum (App. C Alg. 2): branch-free, no magnitude condition."""
    f = fpu(a.dtype)
    a32, b32 = f.load(a), f.load(b)
    x16 = f.round(a32 + b32)
    x = f.load(x16)
    b_virtual = f.sub(x, a32)
    a_virtual = f.sub(x, b_virtual)
    b_roundoff = f.sub(b32, b_virtual)
    a_roundoff = f.sub(a32, a_virtual)
    return x16, f.round(a_roundoff + b_roundoff)


def split(a):
    """Dekker/Veltkamp Split (App. C Alg. 3)."""
    f = fpu(a.dtype)
    p = _SIG_BITS[f.dtype]
    c = p - (p // 2)
    a32 = f.load(a)
    t = f.mul(torch.tensor(2.0**c + 1.0, dtype=F32), a32)
    a_hi16 = f.round(t - f.sub(t, a32))
    return a_hi16, f.round(a32 - f.load(a_hi16))


def two_prod(a, b):
    """TwoProd (App. C Alg. 5): x = RN(a·b), e = a·b − x. For components
    of ≤ 11 significand bits the f32 product is exact, so no FMA is needed."""
    f = fpu(a.dtype)
    a32, b32 = f.load(a), f.load(b)
    prod32 = a32 * b32
    x16 = f.round(prod32)
    return x16, f.round(prod32 - f.load(x16))


def grow(e: Expansion, a) -> Expansion:
    """Grow (Paper Alg. 1): add float ``a`` to the expansion, with TwoSum
    for the first combine (as the JAX package does)."""
    f = fpu(e.hi.dtype)
    x32, y32, a32 = f.load(e.hi), f.load(e.lo), f.load(a)
    u = f.add(x32, a32)
    a_virt = f.sub(u, x32)
    x_virt = f.sub(u, a_virt)
    v = f.add(f.sub(a32, a_virt), f.sub(x32, x_virt))
    t = f.add(y32, v)
    u2_16 = f.round(u + t)
    return Expansion(u2_16, f.round(t - f.sub(f.load(u2_16), u)))


def scaling(e: Expansion, v) -> Expansion:
    """Scaling (App. C Alg. 6): expansion × float."""
    f = fpu(e.hi.dtype)
    x, err = two_prod(e.hi, v)
    x32, err32 = f.load(x), f.load(err)
    err32 = f.add(f.mul(f.load(e.lo), f.load(v)), err32)
    x2_16 = f.round(x32 + err32)
    return Expansion(x2_16, f.round(err32 - f.sub(f.load(x2_16), x32)))


def mul(a: Expansion, b: Expansion) -> Expansion:
    """Mul (App. C Alg. 7): expansion × expansion."""
    f = fpu(a.hi.dtype)
    x, e = two_prod(a.hi, b.hi)
    x32, e32 = f.load(x), f.load(e)
    cross = f.add(f.mul(f.load(a.hi), f.load(b.lo)), f.mul(f.load(a.lo), f.load(b.hi)))
    e32 = f.add(e32, cross)
    x2_16 = f.round(x32 + e32)
    return Expansion(x2_16, f.round(e32 - f.sub(f.load(x2_16), x32)))


def add_expansion(a: Expansion, b: Expansion) -> Expansion:
    """Expansion + expansion → length-2 expansion (renormalized)."""
    s_hi, s_lo = two_sum(a.hi, b.hi)
    f = fpu(a.hi.dtype)
    t = f.add(f.load(a.lo), f.load(b.lo))
    t = f.add(f.load(s_lo), t)
    x16 = f.round(f.load(s_hi) + t)
    return Expansion(x16, f.round(t - f.sub(f.load(x16), f.load(s_hi))))


def from_float(x, dtype=torch.bfloat16, shape: tuple = (), device=None) -> Expansion:
    """A scalar as a length-2 expansion, residual computed in f32
    (0.999 → (1.0, −0.000999…) in bf16, Paper Table 1)."""
    f = fpu(dtype)
    wide = torch.as_tensor(x, dtype=F32, device=device)
    hi16 = f.round(wide)
    lo16 = f.round(wide - f.load(hi16))
    return Expansion(hi16.expand(shape), lo16.expand(shape))


def ulp(x):
    """Unit in the last place (Def. 3.1) for the dtype of x, elementwise,
    from the f32 exponent bits (exact)."""
    p, e_min = _SIG_BITS[x.dtype], _EMIN[x.dtype]
    xf = x.to(F32).abs()
    bits = torch.where(xf > 0, xf, torch.ones_like(xf)).view(torch.int32)
    e = ((bits >> 23) & 0xFF).to(torch.int64) - 127
    e = torch.clamp_min(e, e_min) - (p - 1)
    # uint32 arithmetic of the JAX version, in int64 masked to 32 bits
    u = ((e + 127) << 23) & 0xFFFFFFFF
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(F32)


def stochastic_round(x, dtype, noise):
    """Stochastic rounding f32 → ``dtype`` (App. B): E[SR(x)] = x.

    ``noise``: int64 tensor of x's shape holding 32 uniform random bits per
    element. For bf16, the JAX bit trick: its low 16 bits are added below
    the kept mantissa bits, then the low 16 bits are cut (equal to the JAX
    function given ``jax.random.randint(key, shape, 0, 2**16)`` as noise).
    Otherwise the ulp branch, with the uniform of ``jax.random.uniform``
    made from the same 32 bits (its top 23 bits as a mantissa in [1, 2),
    minus 1)."""
    if dtype == torch.bfloat16:
        return bucketing.stochastic_round_bits(x.to(F32), noise & 0xFFFF).to(torch.bfloat16)
    f = fpu(dtype)
    lo16 = f.round(x)
    lo = f.load(lo16)
    lo = torch.where(lo > x, lo - ulp(lo16), lo)
    gap = ulp(f.store(lo))
    frac = (x - lo) / gap
    uniform = ((noise >> 9) | 0x3F800000).to(torch.int32).view(F32) - 1.0
    return f.store(torch.where(uniform < frac, lo + gap, lo))

