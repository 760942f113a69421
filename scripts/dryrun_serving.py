"""The dry run's serving cells under each tp_mode, side by side.

  PYTHONPATH=src python scripts/dryrun_serving.py [--mesh single_pod] [--force]

Runs ``repro_torch.launch.dryrun.run_cell`` for the prefill_32k and
decode_32k cells of granite-3-2b, internlm2-1.8b, qwen3-moe-30b-a3b,
rwkv6-1.6b and seamless-m4t-medium, and jamba-1.5-large-398b's decode_32k,
each under ``tpmode`` full, mlponly and none (reports under
``experiments/dryrun_torch/<mesh>/``, reused unless ``--force``), then
prints one line a cell: the modelled peak a card, whether it fits 80 GB,
and the census bytes a card by role; or why the cell is refused. The
numbers are modelled (a meta trace of one rank, ``launch/dryrun.py``), not
measured.
"""

import argparse
import time

from repro_torch.launch import dryrun

ARCHS = ("granite-3-2b", "internlm2-1.8b", "qwen3-moe-30b-a3b", "rwkv6-1.6b",
         "seamless-m4t-medium", "jamba-1.5-large-398b")
SHAPES = ("prefill_32k", "decode_32k")
TP_MODES = ("full", "mlponly", "none")


def cells():
    for arch in ARCHS:
        for shape in SHAPES:
            if arch.startswith("jamba") and shape != "decode_32k":
                continue                  # its prefill cell: hours of meta Mamba loops
            for mode in TP_MODES:
                yield arch, shape, mode


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="single_pod", choices=sorted(dryrun.MESHES))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    for arch, shape, mode in cells():
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, args.mesh, force=args.force, variant=f"tpmode={mode}")
        head = f"{arch} {shape} tpmode={mode}:"
        if "refused" in rec or "skipped" in rec:
            print(head, "refused:" if "refused" in rec else "skipped:",
                  rec.get("refused") or rec.get("skipped"), flush=True)
            continue
        pd = rec["per_device"]
        roles = dict(sorted(pd["collective_bytes_by_role"].items()))
        print(f"{head} peak {pd['peak_bytes_modeled'] / 2**30:.2f} GiB a card, fits 80 GB "
              f"{rec['fits_80gb']}, state {pd['state_bytes_by_role']}, census bytes by role "
              f"{roles}, context parallel {rec.get('context_parallel', False)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
