"""The port's examples (``examples/torch_*.py``: the JAX package's
quickstart, serving demo and fault-tolerant training through
``repro_torch``) run with ``--device cpu`` at smoke size, each in a process
of its own, all at once: the quickstart's losses are finite, the serving
demo serves its four runs, the fault-tolerant run recovers from the crash
it injects and ends bitwise-identical to an uninterrupted run. Without
``--device`` each asks for the card, and on a machine without one raises
before any work."""

import math
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
# two threads a process: six at once on a shared host
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
RUNS = {
    "quickstart": ["torch_quickstart.py", "--device", "cpu", "--smoke", "--steps", "4",
                   "--seq-len", "32", "--batch", "4", "--log-every", "1"],
    "serve_demo": ["torch_serve_demo.py", "--device", "cpu"],
    "fault_tolerant": ["torch_fault_tolerant_training.py", "--device", "cpu"],
}


def _start(args):
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / args[0]), *args[1:]],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
                            cwd=ROOT)


@pytest.fixture(scope="module")
def outputs():
    procs = {k: _start(v) for k, v in RUNS.items()}
    if not torch.cuda.is_available():
        procs.update({f"{k}_default": _start(v[:1]) for k, v in RUNS.items()})
    out = {}
    try:
        for k, p in procs.items():
            o, e = p.communicate(timeout=240)
            out[k] = (p.returncode, o, e)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_quickstart_trains(outputs):
    rc, out, err = outputs["quickstart"]
    assert rc == 0, err[-4000:]
    losses = [float(x) for x in re.findall(r"^step\s+\d+ loss ([\d.]+)", out, re.M)]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses), out


def test_serve_demo_serves_every_run(outputs):
    rc, out, err = outputs["serve_demo"]
    assert rc == 0, err[-4000:]
    titles = re.findall(r"^=== (.+) ===$", out, re.M)
    assert [t.split()[0] for t in titles] == ["granite-3-2b", "rwkv6-1.6b", "internvl2-1b",
                                              "gpt-tiny"], out
    assert "speculative" in out and "acceptance" in out


def test_fault_tolerant_run_is_bitwise_identical(outputs):
    rc, out, err = outputs["fault_tolerant"]
    assert rc == 0, err[-4000:]
    assert "!! simulated host failure at step 12" in out
    assert "recovered incidents (faulting steps): [12]" in out
    assert "bitwise-identical to uninterrupted run: True" in out


@pytest.mark.parametrize("name", list(RUNS))
def test_examples_default_to_the_card(outputs, name):
    """Without ``--device`` an example asks for the card: on a machine
    without one it raises, naming ``device='cpu'``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    rc, out, err = outputs[f"{name}_default"]
    assert rc != 0 and "torch.cuda.is_available() is False" in err, (out, err[-2000:])
