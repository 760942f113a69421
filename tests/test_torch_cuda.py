"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, on the card. They carry the ``cuda`` marker and skip without a
card; this file imports no JAX, so it runs on a machine that has none:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as tflash


# (B, H, Hkv, L, dh, causal, window) where the flash kernels' K/V ring,
# heavy-first tile order and edge masks meet their corner cases
RING_SHAPES = [
    (2, 4, 4, 100, 64, True, 0),         # L not a multiple of 64
    (2, 4, 4, 40, 64, True, 0),          # L below one tile
    (1, 4, 2, 2048, 64, True, 0),        # 32 query tiles: the ring wraps, heavy-first order
    (2, 4, 4, 512, 64, True, 16),        # window narrower than one tile
    (2, 4, 4, 190, 64, True, 16),        # ... with a ragged edge
    (2, 12, 4, 512, 64, True, 0),        # GQA 12 / 4
    (2, 4, 4, 512, 128, True, 0),        # dh 128
    (2, 4, 4, 130, 128, False, 0),       # dh 128, not causal, ragged
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,L,dh,causal,window", [
    (8, 12, 12, 512, 64, True, 0),       # gpt-125m serving shape
    (2, 8, 2, 256, 128, True, 0),        # GQA, dh 128
    (2, 4, 4, 512, 64, True, 64),        # sliding window
    (2, 4, 2, 300, 64, True, 0),         # odd L
    (1, 4, 4, 5, 64, True, 0),           # L below one tile
    (2, 4, 2, 200, 64, False, 48),       # non-causal + window
    *RING_SHAPES,
])
def test_kernel_matches_plain_on_card(B, H, Hkv, L, dh, causal, window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(L + H)
    mk = lambda h: torch.randn((B, h, L, dh), generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = mk(H), mk(Hkv), mk(Hkv)
    o, lse = tflash.flash_fwd(q, k, v, causal=causal, window=window)
    po, plse = tflash.flash_fwd_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    # the kernel rounds P to bf16 for the P·V product; the plain version
    # keeps it in f32 (chip_smoke.py gives the tolerances' reasons)
    torch.testing.assert_close(o.float(), po.float(), rtol=2.0**-7, atol=2e-2)
    torch.testing.assert_close(lse, plse, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q = torch.zeros((1, 2, 16, 64), device="cuda", dtype=torch.bfloat16)
    before = tflash.flash_fwd.launches
    with pytest.raises(TypeError):
        tflash.flash_fwd(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        t = q.transpose(2, 3).contiguous().transpose(2, 3)     # not contiguous
        tflash.flash_fwd(t, t, t)
    with pytest.raises(ValueError):
        s = q[..., :32].contiguous()                              # dh 32: not built
        tflash.flash_fwd(s, s, s)
    assert tflash.flash_fwd.launches == before


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,L,dh,causal,window", [
    (8, 12, 12, 512, 64, True, 0),       # gpt-125m training shape
    (2, 8, 2, 256, 128, True, 0),        # GQA, dh 128
    (2, 4, 2, 300, 64, True, 64),        # odd L + window
    (1, 4, 4, 5, 64, True, 0),           # L below one tile
    (2, 4, 2, 200, 64, False, 48),       # non-causal + window
    *RING_SHAPES,
    # dK/dV sums over query rows that the ring zero-fills past a ragged L,
    # across a GQA group
    (2, 12, 4, 300, 64, True, 0),
    (2, 12, 4, 300, 64, False, 0),
    (2, 8, 2, 65, 128, True, 0),
    (2, 12, 4, 190, 64, True, 100),      # GQA, ragged L, a window over two tiles
])
def test_flash_bwd_kernels_match_plain_on_card(B, H, Hkv, L, dh, causal, window):
    _card()
    g = torch.Generator(device="cuda").manual_seed(L + H + 1)
    mk = lambda h: torch.randn((B, h, L, dh), generator=g, device="cuda").to(torch.bfloat16)
    q, k, v, do = mk(H), mk(Hkv), mk(Hkv), mk(H)
    o, lse = tflash.flash_fwd(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window)
    dq, delta = tflash.flash_bwd_dq(q, k, v, lse, do, **kw)
    dq_p, delta_p = tflash.flash_bwd_dq_plain(q, k, v, lse, do, **kw)
    got = (dq, *tflash.flash_bwd_dkv(q, k, v, lse, do, delta, **kw))
    want = (dq_p, *tflash.flash_bwd_dkv_plain(q, k, v, lse, do, delta_p, **kw))
    torch.cuda.synchronize()
    # chip_smoke.py states the reasons for these tolerances
    assert bool(((delta - delta_p).abs() <= 1e-3 * (1 + delta_p.abs())).all())
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        scale = b.abs().max().clamp_min(1e-6)
        assert bool(((a - b).abs() <= 2.0**-6 * b.abs() + 2e-2 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["A", "B", "C", "KAHAN", "SR", "D-", "D"])
@pytest.mark.parametrize("n", [
    3 * 1024, 512 * 128,                 # br 24 and br 256 (two passes): one block a tile
    33 * 1024,                           # 264 rows: br 8, gpt-125m's tile, one warp a tile
    7 * 128, 6 * 128, 2 * 128,           # br 7 (odd), 6, 2: the warp path's narrower loads
])
def test_collage_update_kernel_bit_identical_to_plain(code, n):
    _card()
    from repro_torch.kernels.collage_update import collage_update as cu
    from repro_torch.kernels.collage_update import ref

    state, grad = _update_inputs(code, n)
    kw = _update_kw(code)
    a, pa = cu.collage_bucket_update(state, grad, 1e-3, 0.19, 0.0975, **kw)
    b, pb = ref.collage_bucket_update_plain(state, grad, 1e-3, 0.19, 0.0975, **kw)
    torch.cuda.synchronize()
    for f in a:
        assert torch.equal(a[f].view(torch.uint8), b[f].view(torch.uint8)), f
    for x, y in zip(pa, pb):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["A", "B", "C", "KAHAN", "SR", "D-", "D"])
@pytest.mark.parametrize("n", [512 * 128, 33 * 1024, 7 * 128])   # br 256 (two passes), 8, 7
def test_collage_update_in_place_bit_identical_to_out_of_place(code, n):
    """``in_place`` (the donated train step) writes the same bits over the
    inputs, on both kernel paths and for a tile that takes two passes."""
    _card()
    from repro_torch.kernels.collage_update import collage_update as cu

    state, grad = _update_inputs(code, n)
    kw = _update_kw(code)
    a, pa = cu.collage_bucket_update(state, grad, 1e-3, 0.19, 0.0975, **kw)
    mine = {f: t.clone() for f, t in state.items()}
    b, pb = cu.collage_bucket_update(mine, grad, 1e-3, 0.19, 0.0975, in_place=True, **kw)
    torch.cuda.synchronize()
    for f in a:
        assert b[f] is mine[f]
        assert torch.equal(a[f].view(torch.uint8), b[f].view(torch.uint8)), f
    for x, y in zip(pa, pb):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _update_inputs(code, n):
    from repro_torch.kernels.collage_update import collage_update as cu

    g = torch.Generator(device="cuda").manual_seed(n)
    rnd = lambda s: torch.randn((n,), generator=g, device="cuda") * s
    scales = {"theta": 0.05, "m": 1e-3, "vhi": 1e-5, "vlo": 1e-9, "delta": 1e-5,
              "master": 0.05}
    state = {f: (rnd(scales[f]).abs() if f == "vhi" else rnd(scales[f])).to(
        cu.field_dtype(f, code)) for f in cu.state_fields(code)}
    return state, rnd(1e-2).to(torch.bfloat16)


def _update_kw(code):
    return dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1, strategy=code, compute_metrics=True,
                pt_decay=code == "A", seed=77 if code == "SR" else None,
                elem_offset=2**32 - 1024 if code == "SR" else None)


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["B", "C", "KAHAN"])
def test_collage_update_kernel_keeps_subnormals(code):
    """Low parts and Kahan compensations in the f32/bf16 subnormal range:
    the kernel's bf16 rounding keeps subnormals, as the plain version's."""
    _card()
    from repro_torch.kernels.collage_update import collage_update as cu
    from repro_torch.kernels.collage_update import ref

    n = 33 * 1024                        # br 8: the warp path
    state, grad = _update_inputs(code, n)
    g = torch.Generator(device="cuda").manual_seed(3)
    for f in ("vlo", "delta"):
        if f in state:
            tiny = torch.randn((n,), generator=g, device="cuda") * 1e-39
            state[f] = tiny.to(torch.bfloat16)
            assert bool((state[f] != 0).any())
    kw = _update_kw(code)
    a, pa = cu.collage_bucket_update(state, grad, 1e-3, 0.19, 0.0975, **kw)
    b, pb = ref.collage_bucket_update_plain(state, grad, 1e-3, 0.19, 0.0975, **kw)
    torch.cuda.synchronize()
    for f in a:
        assert torch.equal(a[f].view(torch.uint8), b[f].view(torch.uint8)), f
    for x, y in zip(pa, pb):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["C", "SR", "D"])
def test_collage_update_unaligned_bucket_matches_aligned(code):
    """A bucket whose pointers are not 16-byte aligned takes the one-block
    path with scalar loads: same bits as the warp path on aligned copies."""
    _card()
    from repro_torch.kernels.collage_update import collage_update as cu

    n = 33 * 1024                        # br 8
    state, grad = _update_inputs(code, n)
    shifted = lambda t: torch.cat([t.new_zeros(1), t])[1:]   # contiguous, 2 or 4 B off
    kw = _update_kw(code)
    a, pa = cu.collage_bucket_update(state, grad, 1e-3, 0.19, 0.0975, **kw)
    b, pb = cu.collage_bucket_update({f: shifted(t) for f, t in state.items()}, shifted(grad),
                                     1e-3, 0.19, 0.0975, **kw)
    torch.cuda.synchronize()
    assert grad.data_ptr() % 16 == 0 and shifted(grad).data_ptr() % 16
    for f in a:
        assert torch.equal(a[f].view(torch.uint8), b[f].view(torch.uint8)), f
    for x, y in zip(pa, pb):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
def test_bwd_wrappers_raise_on_what_the_kernels_do_not_take():
    _card()
    q = torch.zeros((1, 2, 16, 64), device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 16), device="cuda")
    before = (tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches)
    with pytest.raises(TypeError):
        tflash.flash_bwd_dq(q.float(), q.float(), q.float(), lse, q.float())
    with pytest.raises(TypeError):
        tflash.flash_bwd_dkv(q, q, q, lse.to(torch.bfloat16), q, lse)
    with pytest.raises(ValueError):
        tflash.flash_bwd_dq(q, q, q, lse[..., :8], q)
    assert (tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches) == before


def _edq_inputs(n, seed):
    """u, e on the card with lost elements (e == 0 where u != 0), exact
    zeros in both, and mixed signs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((n,), generator=g, device="cuda") * 1e-3
    e = u * (1 + 0.01 * torch.randn((n,), generator=g, device="cuda"))
    pick = torch.rand((n,), generator=g, device="cuda")
    e = torch.where(pick < 0.1, torch.zeros_like(e), e)            # lost
    u = torch.where((pick > 0.95) & (pick < 0.97), torch.zeros_like(u), u)   # u == 0
    e = torch.where(pick > 0.99, -e, e)                            # sign flips
    return u.contiguous(), e.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 1000, 128 * 77, 16384 * 3 + 7, 7_077_888])
def test_edq_kernel_matches_plain_on_card(n):
    _card()
    from repro_torch.kernels.edq import edq as kedq
    from repro_torch.kernels.edq import ref

    u, e = _edq_inputs(n, n)
    before = kedq.edq_partials.launches
    got = kedq.edq_partials(u, e)
    want = ref.edq_partials_plain(u, e)
    torch.cuda.synchronize()
    assert kedq.edq_partials.launches == before + 1
    # chip_smoke.py states the reasons for these tolerances
    scale = (u * e).abs().sum()
    assert abs(float(got[0] - want[0])) <= 1e-5 * float(scale)
    torch.testing.assert_close(got[1:3], want[1:3], rtol=1e-5, atol=0)
    assert float(got[3]) == float(want[3])
    # an input that is not 16-byte aligned takes the same elements in order
    if n > 8:
        u2, e2 = torch.empty(n + 1, device="cuda"), torch.empty(n + 1, device="cuda")
        u2[1:], e2[1:] = u, e
        assert torch.equal(kedq.edq_partials(u2[1:], e2[1:]), got)


@pytest.mark.cuda
def test_edq_wrapper_raises_on_what_the_kernel_does_not_take():
    _card()
    from repro_torch.kernels.edq import edq as kedq

    u = torch.ones(256, device="cuda")
    before = kedq.edq_partials.launches
    with pytest.raises(TypeError):
        kedq.edq_partials(u.to(torch.bfloat16), u.to(torch.bfloat16))
    with pytest.raises(ValueError):
        kedq.edq_partials(u, u[:128])
    with pytest.raises(ValueError):
        kedq.edq_partials(u.reshape(16, 16), u.reshape(16, 16))
    with pytest.raises(ValueError):
        kedq.edq_partials(u[::2], u[::2])
    with pytest.raises(ValueError):
        kedq.edq_partials(u, u.cpu())
    assert kedq.edq_partials.launches == before


@pytest.mark.cuda
def test_edq_kernel_lost_count_exact_past_2_24():
    _card()
    from repro_torch.kernels.edq import edq as kedq

    n = 2**24 + 6
    got = kedq.edq_partials(torch.ones(n, device="cuda"), torch.zeros(n, device="cuda"))
    torch.cuda.synchronize()
    assert float(got[3]) == float(torch.tensor(float(n), dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape_a,shape_b", [((300, 64), (64, 1001)),       # the head, odd N
                                             ((6, 70, 32), (6, 32, 90))])   # the GQA products
def test_matmul_f32_on_card_matches_f32_product(shape_a, shape_b):
    """``layers.matmul_f32`` on the card: one bf16 product with f32 output,
    and the backward's two products on the bf16-rounded cotangent. Forward
    against the f32 product of the same bf16 operands (summation order
    only); gradients against autograd of that f32 product, where g is not
    rounded (g's rounding is 2^-9 relative per element)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: mm.dtype has no CPU kernel")
    from repro_torch.models.layers import matmul_f32
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(shape_a, generator=g, device="cuda").bfloat16().requires_grad_(True)
    b = torch.randn(shape_b, generator=g, device="cuda").bfloat16().requires_grad_(True)
    out = matmul_f32(a, b)
    ref = torch.matmul(a.float(), b.float())
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
    gy = torch.randn(out.shape, generator=g, device="cuda")
    da, db = torch.autograd.grad(out, (a, b), gy)
    ra, rb = torch.autograd.grad(ref, (a, b), gy)
    assert da.dtype == db.dtype == torch.bfloat16
    for got, want in ((da, ra), (db, rb)):
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-6,
                                   atol=2.0**-6 * want.abs().max().item())


# verify against sequential decode on the card, gpt-125m in bf16, at
# chip_smoke.py's fixed 8-slot state: products over B·W rows and over B rows
# take other cuBLAS kernels and round at other points. chip_smoke.py's
# serve_continuous phase measured a largest logit gap of 2.17e-2 at this
# state (NVIDIA H100 80GB HBM3, 700 W); 0.05 leaves twice that.
VERIFY_GAP_ATOL = 0.05


def _gpt125m_slots(n_slots, lens, slot_idx, seed=0):
    """gpt-125m (flash above 256) and an arena of ``n_slots`` slots with one
    prefill batch of prompts of ``lens`` (bucket 512) written at
    ``slot_idx``; returns (model, params, slots, batch, prompt_lens)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gpt-125m"), flash_min_len=256)
    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    toks = np.random.default_rng(seed).integers(2, cfg.vocab_size, size=(len(lens), 512))
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    plens = torch.tensor(lens, device="cuda")
    slots = model.init_slot_state(n_slots, 576, device="cuda")
    model.prefill_into(params, slots, batch, slot_idx, [64] * len(lens), cache_len=576,
                       prompt_lens=plens)
    return model, params, slots, batch, plens


@pytest.mark.cuda
def test_verify_matches_sequential_decode_on_card():
    """One width-5 verify against 5 sequential decode steps fed the same
    greedy tokens, at chip_smoke.py's fixed slot state (profile_serve's
    trace, its first 8 requests)."""
    _card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import profile_serve as pserve
    from repro_torch.models.model import build_model, greedy_tokens

    model = build_model(dataclasses.replace(get_config("gpt-125m"), flash_min_len=256))
    params = model.init(0, device="cuda")
    slots, _, _, _ = pserve.fixed_slot_state(model, params, model, params,
                                             pserve.trace_requests(model.cfg.vocab_size))
    seq, tok, fed, want = slots.state.clone(), slots.tok.clone(), [], []
    for _ in range(5):
        fed.append(tok)
        logits, seq = model.decode_step(params, seq, tok)
        want.append(logits[:, 0])
        tok = greedy_tokens(logits[:, -1])[:, None]
    got, ver = model.decode_verify(params, slots.state.clone(), torch.cat(fed, dim=1))
    torch.cuda.synchronize()
    gap = (got - torch.stack(want, 1)).abs().max().item()
    assert gap <= VERIFY_GAP_ATOL, gap
    assert torch.equal(ver.pos, seq.pos)


@pytest.mark.cuda
def test_prefill_into_rows_match_a_closed_prefill_on_card():
    """A prefill batch of 4 (one dummy row) written into slots 6, 1, 3 of an
    8-slot arena: those rows are bit-identical to the closed prefill of the
    same batch, every other slot stays zero."""
    _card()
    model, params, slots, batch, plens = _gpt125m_slots(8, [512, 300, 257, 400], [6, 1, 3, 8])
    _, closed = model.prefill(params, batch, 576, prompt_lens=plens)
    for arena, ref in zip(slots.state.layers, closed.layers):
        for key, sub in arena.items():
            for name, t in sub.items():
                assert torch.equal(t[:, [6, 1, 3]], ref[key][name][:, :3])
                assert not t[:, [0, 2, 4, 5, 7]].any()
    assert slots.state.pos.tolist() == [0, 300, 0, 257, 0, 0, 512, 0]
    assert slots.active.tolist() == [False, True, False, True, False, False, True, False]


@pytest.mark.cuda
def test_segment_and_verify_round_make_no_host_sync_on_card():
    """decode_segment and a speculative round (draft_propose + spec_verify)
    read nothing back to the host: torch.cuda's sync debug mode raises on
    any synchronising call inside them."""
    _card()
    from repro_torch.launch.serve import draft_from_target

    model, params, slots, batch, plens = _gpt125m_slots(4, [512, 300, 257, 400], [0, 1, 2, 3])
    dm, dp = draft_from_target(model, params, "layers:2")
    draft = dm.init_decode_state(4, 576, device="cuda")
    dm.prefill_state_into(dp, draft, batch, [0, 1, 2, 3], cache_len=576, prompt_lens=plens)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_segment(params, slots, seg_len=4, eos_id=1)
        props, _ = dm.draft_propose(dp, draft, slots.tok, slots.state.pos, slots.run, spec_k=3)
        model.spec_verify(params, slots, props, eos_id=1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (slots.n_gen >= 6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rwkv_tmix", "rwkv_cmix", "mamba"])
def test_recurrent_mixers_on_card_match_the_cpu(kind):
    """The recurrent mixers (chunked apply and six decode steps) in f32 on
    the card against the same on the CPU, at smoke width with a chunk
    boundary inside L 21: the same f32 operations summed in other orders
    (rtol/atol 1e-4, tests/test_torch_families.py's f32 tolerance)."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv, ssm

    arch = "jamba-1.5-large-398b" if kind == "mamba" else "rwkv6-1.6b"
    cfg = get_config(arch, smoke=True)
    init = {"mamba": ssm.mamba_init, "rwkv_tmix": rwkv.rwkv_tmix_init,
            "rwkv_cmix": rwkv.rwkv_cmix_init}[kind]
    apply = {"mamba": ssm.mamba_apply, "rwkv_tmix": rwkv.rwkv_tmix_apply,
             "rwkv_cmix": rwkv.rwkv_cmix_apply}[kind]
    step = {"mamba": ssm.mamba_decode, "rwkv_tmix": rwkv.rwkv_tmix_decode,
            "rwkv_cmix": rwkv.rwkv_cmix_decode}[kind]
    p = {k: v[0] for k, v in init(torch.Generator().manual_seed(0), cfg, torch.float32,
                                  1).items()}
    x = torch.randn((2, 21, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.5
    pc = {k: v.cuda() for k, v in p.items()}
    torch.testing.assert_close(apply(pc, x.cuda(), cfg).cpu(), apply(p, x, cfg),
                               rtol=1e-4, atol=1e-4)
    if kind == "mamba":
        st = ssm.mamba_init_state(cfg, 2, torch.float32, "cpu")
    elif kind == "rwkv_tmix":
        st = rwkv.rwkv_tmix_init_state(cfg, 2, torch.float32, "cpu")
    else:
        st = {"last_x": torch.zeros((2, cfg.d_model))}
    stc = {k: v.cuda() for k, v in st.items()}
    for t in range(6):
        o, st = step(p, x[:, t:t + 1], cfg, st)
        oc, stc = step(pc, x[:, t:t + 1].cuda(), cfg, stc)
        torch.testing.assert_close(oc.cpu(), o, rtol=1e-4, atol=1e-4)
        for k in st:
            torch.testing.assert_close(stc[k].cpu(), st[k], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_recurrent_slot_arena_makes_no_host_sync_on_card(arch):
    """A recurrent arch (smoke size, bf16): init_slot_state, prefill_into at
    one exact length (no prompt_lens) and a decode segment read nothing
    back to the host (torch.cuda's sync debug mode raises on any
    synchronising call inside them); the prefilled rows equal a closed
    prefill's bit for bit."""
    _card()
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    model = build_model(get_config(arch, smoke=True))
    params = model.init(0, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(2, 256, size=(3, 13))).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slots = model.init_slot_state(4, 32, device="cuda")
        model.prefill_into(params, slots, {"tokens": toks}, [3, 0, 4], [8, 8, 1], cache_len=32)
        model.decode_segment(params, slots, seg_len=4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert slots.n_gen.tolist() == [5, 0, 0, 5] and slots.state.pos.tolist() == [17, 0, 0, 17]
    fresh = model.init_slot_state(4, 32, device="cuda")
    model.prefill_into(params, fresh, {"tokens": toks}, [3, 0, 4], [8, 8, 1], cache_len=32)
    _, closed = model.prefill(params, {"tokens": toks}, 32)
    for arena, ref in zip(fresh.state.layers, closed.layers):
        for key, sub in arena.items():
            for name, t in sub.items():
                assert torch.equal(t[:, [3, 0]], ref[key][name][:, :2]), (key, name)
                assert not t[:, [1, 2]].any(), (key, name)


def _frontend_smoke(arch, dtype):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    return build_model(cfg), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b"])
def test_frontend_families_on_card_match_the_cpu(arch):
    """Cross-attention over the encoder's memory (seamless) and the decoder's
    patch prefix (internvl2), smoke size in f32: the forward, a ragged
    prefill and three decode steps on the card against the same weights on
    the CPU (rtol/atol 1e-4, tests/test_torch_families.py's f32 tolerance),
    and the same positions."""
    _card()
    import numpy as np

    from repro_torch.models.model import ParamTree, param_dict

    model, cfg = _frontend_smoke(arch, "float32")
    p = model.init(0, device="cpu")
    pc = ParamTree(_map(param_dict(p), lambda t: t.cuda()))
    g = np.random.default_rng(0)
    toks = torch.from_numpy(g.integers(2, cfg.vocab_size, size=(3, 12)))
    fe = torch.from_numpy(g.standard_normal((3, cfg.frontend_len, cfg.d_model),
                                            dtype=np.float32) * 0.1)
    batch = {"tokens": toks, "frontend": fe}
    cbatch = {k: v.cuda() for k, v in batch.items()}
    close = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(model.forward(pc, cbatch)[0].cpu(), model.forward(p, batch)[0],
                               **close)
    lens = torch.tensor([12, 5, 9])
    lg, st = model.prefill(p, batch, 24, prompt_lens=lens)
    lgc, stc = model.prefill(pc, cbatch, 24, prompt_lens=lens.cuda())
    torch.testing.assert_close(lgc.cpu(), lg, **close)
    for t in range(3):
        nxt = toks[:, t:t + 1]
        lg, st = model.decode_step(p, st, nxt)
        lgc, stc = model.decode_step(pc, stc, nxt.cuda())
        torch.testing.assert_close(lgc.cpu(), lg, **close)
    assert stc.pos.tolist() == st.pos.tolist() == (model._prefix_len + lens + 3).tolist()


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(v, fn) for v in node]
    return fn(node)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b"])
def test_frontend_slot_arena_makes_no_host_sync_on_card(arch):
    """A frontend arch (smoke size, bf16): init_slot_state, prefill_into of
    a ragged batch with its frontends and a dummy row (zero frontend, slot
    index past the arena), and a decode segment read nothing back to the
    host (torch.cuda's sync debug mode raises on any synchronising call);
    the live rows, cross-attention caches included, equal a closed
    prefill's bit for bit and the other slots stay zero."""
    _card()
    import numpy as np

    model, cfg = _frontend_smoke(arch, "bfloat16")
    params = model.init(0, device="cuda")
    g = np.random.default_rng(1)
    toks = torch.from_numpy(g.integers(2, cfg.vocab_size, size=(3, 16))).cuda()
    fe = torch.from_numpy(g.standard_normal((3, cfg.frontend_len, cfg.d_model),
                                            dtype=np.float32) * 0.1).cuda()
    fe[2] = 0                                        # the dummy row's zero frontend
    batch = {"tokens": toks, "frontend": fe}
    lens = torch.tensor([16, 9, 16], device="cuda")
    F, S = model._prefix_len, 64
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slots = model.init_slot_state(4, S, device="cuda")
        model.prefill_into(params, slots, batch, [3, 0, 4], [8, 8, 1], cache_len=S,
                           prompt_lens=lens)
        model.decode_segment(params, slots, seg_len=4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert slots.n_gen.tolist() == [5, 0, 0, 5]
    assert slots.state.pos.tolist() == [F + 9 + 4, 0, 0, F + 16 + 4]
    fresh = model.init_slot_state(4, S, device="cuda")
    model.prefill_into(params, fresh, batch, [3, 0, 4], [8, 8, 1], cache_len=S,
                       prompt_lens=lens)
    _, closed = model.prefill(params, batch, S, prompt_lens=lens)
    for arena, ref in zip(fresh.state.layers, closed.layers):
        for key, sub in arena.items():
            for name, t in sub.items():
                assert torch.equal(t[:, [3, 0]], ref[key][name][:, :2]), (key, name)
                assert not t[:, [1, 2]].any(), (key, name)
