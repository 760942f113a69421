"""Card-only test of the audit's trace (repro_torch.analysis.trace): it
carries the ``cuda`` marker and skips without a card; this file imports
no JAX, so it runs on a machine that has none:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_audit_cuda.py
"""

import pytest
import torch

from repro_torch.analysis import record_step
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.models.model import build_model
from repro_torch.train import train_loop


@pytest.mark.cuda
def test_trace_holds_the_backward_run_on_the_cards_autograd_thread():
    """On the card the autograd engine runs the backward on a device
    thread: the dispatch trace must still see its ops; the bf16 products
    with f32 output (``mm.dtype``/``bmm.dtype``) count FLOPs, and the fused
    update's launch is logged with its bucket."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward's device thread exists only there")
    cfg = get_config("gpt-tiny", smoke=True)
    model = build_model(cfg)
    opt = CollageAdamW(1e-4, policy=PrecisionPolicy(bucketing=BucketPolicy(enabled=True)),
                       use_fused_kernel=True)
    state = train_loop.init_state(model, opt, 0, device="cuda")
    batch = make_batch_fn(cfg, ShapeConfig("t", 64, 2, "train"), device="cuda")(0)
    (_, _), trace = record_step(train_loop.make_train_step(model, opt), state, batch,
                                device="cuda")
    trace.require_backward()
    assert any(op.backward and op.device == "cuda" for op in trace.ops)
    assert any(op.op.endswith(".dtype") and op.flops > 0 for op in trace.ops)
    assert [(k.name, k.args["n"]) for k in trace.kernels] == \
        [("collage_bucket_update", state.params.layout.buckets[0].padded)]
