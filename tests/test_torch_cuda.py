"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, on the card. They carry the ``cuda`` marker and skip without a
card; this file imports no JAX, so it runs on a machine that has none:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as tflash


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,L,dh,causal,window", [
    (8, 12, 12, 512, 64, True, 0),       # gpt-125m serving shape
    (2, 8, 2, 256, 128, True, 0),        # GQA, dh 128
    (2, 4, 4, 512, 64, True, 64),        # sliding window
    (2, 4, 2, 300, 64, True, 0),         # odd L
    (1, 4, 4, 5, 64, True, 0),           # L below one tile
    (2, 4, 2, 200, 64, False, 48),       # non-causal + window
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
