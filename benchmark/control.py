"""The control: the reference put in the program's place with one of the
configuration's guarantees broken, run through a cell as the benchmark
runs it, to show that the comparison deciding ``correct`` fails it.

The broken guarantee is the first of each configuration's: the extension
is the same additive-FFT Reed-Solomon code over the standard basis in
place of the Cantor basis (reference/leopard.CONTROL_FIELDS), a
maximum-distance-separable code as good as the protocol's for recovery
but not the bytes consensus commits to: the shortcut a faster encoder
might take. In a withheld-square cell the control repairs the square
with the plain reference decoder over that code (reference/decode.py).
Every count the check compares is printed per seed.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 [--seconds 1]

The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness, spec  # noqa: E402
from benchmark.reference import decode  # noqa: E402
from benchmark.reference import eds as ref_eds  # noqa: E402


def control_entry(batched: bool):
    """An entry(ods, device) that answers with the control's commitment."""

    def entry(arg, device):
        odss = np.asarray(arg) if batched else np.asarray(arg)[None]
        c = ref_eds.commit(torch.from_numpy(odss.copy()).to(device or "cuda"), control=True)
        out = []
        for i in range(odss.shape[0]):
            rows = tuple(r.tobytes() for r in c.row_roots[i].cpu().numpy())
            cols = tuple(r.tobytes() for r in c.col_roots[i].cpu().numpy())
            out.append(SimpleNamespace(eds=SimpleNamespace(squares=c.eds[i].cpu().numpy()),
                                       dah=SimpleNamespace(row_roots=rows, col_roots=cols),
                                       data_root=c.data_root[i].cpu().numpy().tobytes()))
        return out if batched else out[0]

    return entry


def control_repair_entry():
    """An entry(symbols, present, row_roots, col_roots, device) that
    answers with the square the control's code decodes."""

    def entry(symbols, present, row_roots, col_roots, device=None):
        dev = device or "cuda"
        sq = decode.repair(torch.from_numpy(np.array(symbols)).to(dev), torch.from_numpy(np.array(present)).to(dev),
                           control=True)
        return sq.cpu().numpy()

    return entry


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA card", file=sys.stderr)
        return 2
    withheld = cell.traffic.get("handover") == "withheld-quadrant"
    for seed in (int(s) for s in args.seeds.split(",")):
        entry = control_repair_entry() if withheld else control_entry(bool(cell.traffic["batched"]))
        r = harness.run(cell, seed, args.seconds, False, "cuda", time.perf_counter(), entry=entry)
        print(json.dumps({"control": cell.name, "seed": seed, "correct": r["correct"],
                          "checked_blocks": r["_counted"]["checked_blocks"], "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
