"""The dry run's serving cells under each tp_mode, side by side.

  PYTHONPATH=src python scripts/dryrun_serving.py [--mesh single_pod] [--force] [--sp]

Runs ``repro_torch.launch.dryrun.run_cell`` for the prefill_32k and
decode_32k cells of granite-3-2b, internlm2-1.8b, qwen3-moe-30b-a3b,
rwkv6-1.6b and seamless-m4t-medium, and jamba-1.5-large-398b's decode_32k,
each under ``tpmode`` full, mlponly and none (reports under
``experiments/dryrun_torch/<mesh>/``, reused unless ``--force``), then
prints one line a cell: the modelled peak a card, whether it fits 80 GB,
and the census bytes a card by role; or why the cell is refused. ``--sp``
runs instead the sequence-parallel cells beside the same cells without it
(``SP_CELLS``: granite's, seamless's and qwen3-moe's prefill_32k,
internvl2-1b's prefill_32k under ``tpmode=none``, the reference's
hill-climb variant, and granite's decode_32k, where ``sp=1`` splits
nothing). The numbers are modelled (a meta trace of one rank,
``launch/dryrun.py``), not measured.
"""

import argparse
import time

from repro_torch.launch import dryrun

ARCHS = ("granite-3-2b", "internlm2-1.8b", "qwen3-moe-30b-a3b", "rwkv6-1.6b",
         "seamless-m4t-medium", "jamba-1.5-large-398b")
SHAPES = ("prefill_32k", "decode_32k")
TP_MODES = ("full", "mlponly", "none")


# (arch, shape, tpmode) run with sp=0 and sp=1 under --sp
SP_CELLS = (("granite-3-2b", "prefill_32k", "full"), ("seamless-m4t-medium", "prefill_32k", "full"),
            ("qwen3-moe-30b-a3b", "prefill_32k", "full"), ("internvl2-1b", "prefill_32k", "none"),
            ("granite-3-2b", "decode_32k", "full"))


def cells(sp=False):
    """(arch, shape, variant) of each cell to run."""
    if sp:
        for arch, shape, mode in SP_CELLS:
            yield arch, shape, f"tpmode={mode}"
            yield arch, shape, f"tpmode={mode},sp=1"
        return
    for arch in ARCHS:
        for shape in SHAPES:
            if arch.startswith("jamba") and shape != "decode_32k":
                continue                  # its prefill cell: hours of meta Mamba loops
            for mode in TP_MODES:
                yield arch, shape, f"tpmode={mode}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="single_pod", choices=sorted(dryrun.MESHES))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--sp", action="store_true",
                    help="the sequence-parallel cells (SP_CELLS), each beside its sp=0 cell")
    args = ap.parse_args(argv)
    for arch, shape, variant in cells(args.sp):
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, args.mesh, force=args.force, variant=variant)
        head = f"{arch} {shape} {variant}:"
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
