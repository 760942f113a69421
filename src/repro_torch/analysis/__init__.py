"""The audit of one train step, the port of ``repro.analysis`` (DESIGN.md §8).

The JAX package's passes parse lowered StableHLO and compiled HLO text.
Eager PyTorch has no IR, so the port's passes read what one step actually
did (``trace``): a dispatch-mode record of its aten calls, the storages it
held, and its kernel launches, beside the ``TrainState`` it returned.

  trace          — the recorder: ops, storage lifetimes, kernel launches
  precision_flow — the no-master-copy census of the state + the wide
                   transients and double-round chains of the trace
  donation       — a donated step's buckets written in place, by storage
  liveness       — modelled peak from storage intervals; measured on the card
  cost_model     — roofline time per op and kernel on the H100's data sheet
  source_lint    — AST lint for f32 promotion idioms in models/ and core/
  audit          — per-cell orchestration of the passes

The audit script is ``repro_torch.launch.precision_audit``.
"""
from repro_torch.analysis.audit import (MASTER_COPY_STRATEGIES, audit_cell,  # noqa: F401
                                        is_sixteen_bit)
from repro_torch.analysis.cost_model import model_step  # noqa: F401
from repro_torch.analysis.donation import (assert_donation_realized,  # noqa: F401
                                           check_donation, donated_storages)
from repro_torch.analysis.liveness import measured_peak, peak_hbm  # noqa: F401
from repro_torch.analysis.precision_flow import (analyze_precision_flow,  # noqa: F401
                                                 assert_no_master_copy, census)
from repro_torch.analysis.source_lint import lint_file, lint_paths  # noqa: F401
from repro_torch.analysis.trace import record_kernels, record_step, recording  # noqa: F401
