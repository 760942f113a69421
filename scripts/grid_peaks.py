"""Phase 13 of chip_smoke.py (internlm2-1.8b, four ranks sharing one NVIDIA
card as data 2 x model 2) run from each given checkout in turn, in one
process tree, printing each rank's device memory peak over its training
runs and over its first gradient beside the card's name and power limit.

  python3 scripts/grid_peaks.py DIR [DIR ...]     # on a machine with one card

Each DIR holds a checkout of the repository (for instance an older commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists). A
checkout whose phase 13 does not report its ranks' training peak yet gets
the lines that do, written into its own ``chip_smoke.py`` (record
``torch.cuda.max_memory_allocated()`` in each rank over the training runs
and over the first tree-C gradient, print them): nothing else of that
checkout changes, so the peaks of two commits compare on the same card in
the same call. Each checkout builds its
own kernels (phase 1) before its phase 13.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

# (anchor, text placed before it, text placed after it): the lines of
# chip_smoke.py's phase 13 that record and print the peaks
PATCHES = (
    ('            ce, grads = step.grads(loc.params, batch_fn(i))\n',
     '            if label == "grid_train" and i == 0:       # the first gradient\'s own peak\n'
     '                out["peak_before_grads"] = torch.cuda.max_memory_allocated()\n'
     '                torch.cuda.reset_peak_memory_stats()\n',
     '            if label == "grid_train" and i == 0:\n'
     '                out["peak_grads"] = torch.cuda.max_memory_allocated()\n'),
    ('    t_train = time.perf_counter()\n', '',
     '    out["peak_train"] = max(out["peak_before_grads"], torch.cuda.max_memory_allocated())\n'),
    ('        print(f"  phase 13 parts: one-rank references',
     '        print(f"  grid training peak GiB by rank: "\n'
     '              f"{[round(x[\'peak_train\'] / 2**30, 3) for x in ranks]}; over the first C "\n'
     '              f"gradient (step.grads): {[round(x[\'peak_grads\'] / 2**30, 3) for x in ranks]}")\n',
     ''),
)


def instrument(path: str) -> bool:
    """Add the peaks' record and report to the ``chip_smoke.py`` at ``path``
    if it lacks them → whether the file was changed."""
    with open(path) as f:
        src = f.read()
    if "peak_grads" in src:
        return False
    for anchor, before, after in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"{path}: cannot place the peak's lines (anchor {anchor.strip()!r})")
        src = src.replace(anchor, before + anchor + after)
    with open(path, "w") as f:
        f.write(src)
    return True


def main(dirs) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    code = "import chip_smoke as c; c.phase_environment(); c.phase_grid()"
    for d in dirs:
        changed = instrument(os.path.join(d, "chip_smoke.py"))
        run = subprocess.run([sys.executable, "-c", code], cwd=d, capture_output=True, text=True)
        lines = [ln for ln in run.stdout.splitlines()
                 if re.search(r"peak GiB|step ms by rank|phase 13 parts", ln)]
        print(f"{d} (peak lines {'added' if changed else 'its own'}): exit {run.returncode}")
        for ln in lines:
            print(f"  {ln.strip()}")
        if run.returncode:
            print(run.stdout[-3000:], run.stderr[-6000:], sep="\n")
            return run.returncode
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1:]))
