"""Audit orchestration: the four passes over one traced step, the port of
``repro.analysis.audit``.

Dict in, dict out: the caller (``launch.precision_audit``, ``chip_smoke.py``,
the tests) builds the cell, runs the step under ``trace.record_step`` and
hands over the trace, the state the step returned, the donated storages it
noted before the step and the collectives it made.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.analysis.cost_model import model_step
from repro_torch.analysis.donation import check_donation
from repro_torch.analysis.liveness import peak_hbm
from repro_torch.analysis.precision_flow import analyze_precision_flow
from repro_torch.analysis.trace import Trace

# D is the deliberate fp32-master-weights baseline. D⁻ keeps no master copy
# but its moments are f32 (Paper Table 2): its state is not (16,16) either,
# and the census reports its f32 leaves by role (m, v) apart from D's
# master. Every other strategy claims the (16,16) no-master-copy property.
MASTER_COPY_STRATEGIES = ("D",)
WIDE_STATE_STRATEGIES = ("D-MW", "D")


def is_sixteen_bit(strategy: str) -> bool:
    return strategy not in WIDE_STATE_STRATEGIES


def audit_cell(trace: Trace, state, *, strategy: str, donated: Optional[dict] = None,
               census: Optional[list] = None, n_dp: int = 1) -> dict:
    """Full audit of one (config × strategy × mode) cell: ``trace`` the
    record of one step, ``state`` the TrainState it returned, ``donated``
    ``donation.donated_storages`` of its input (empty: not donated),
    ``census`` the collectives it made over ``n_dp`` ranks."""
    pf = analyze_precision_flow(trace, state, sixteen_bit=is_sixteen_bit(strategy))
    don = check_donation(donated or {}, state)
    live = peak_hbm(trace)
    cost = model_step(trace, census, n_dp)
    return {
        "strategy": strategy,
        "precision_flow": pf,
        "donation": don,
        "liveness": live,
        "cost": cost,
        "ok": {
            # the invariant (16-bit cells) / its deliberate violation (D)
            "no_master_copy": pf["no_master_copy"],
            "all_donations_realized": don["all_donations_realized"],
        },
    }
