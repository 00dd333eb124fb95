"""Run one cell of BENCHMARK.json once and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Standard output ends with one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``,
and last ``checks``, each number compared beside its limit; the line
before it counts what the run did. The checks are also the last lines of
standard error. The run sees the cell's cards and no others (the first
``chips`` of the visible ones); without a card, or with fewer cards than
the cell asks for, it prints no result and exits 2; if the program's JAX
original (or JAX) is loaded once the run is over, it exits 3.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CHECKOUT / "benchmark" / ".cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CHECKOUT / "benchmark" / ".cache" / "triton"))

FORBIDDEN = ("jax", "jaxlib", "flax", "celestia_app_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (compared whole) is JAX's or the
    JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def pin_cards(chips: int, environ=os.environ) -> None:
    """Make the first `chips` cards of those visible the only ones CUDA
    sees, so that the program's own choices (the auto rule shards over
    every visible card) follow the cell and not the machine. Called before
    CUDA starts."""
    visible = environ.get("CUDA_VISIBLE_DEVICES")
    ids = [i for i in visible.split(",") if i.strip()] if visible is not None else [str(i) for i in range(chips)]
    environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:chips])


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import spec

    cell = spec.load(args.workload)
    pin_cards(cell.chips)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() != cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s), it sees {have}; "
              "no result", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or of the JAX package were loaded: {found}; no result",
              file=sys.stderr)
        return 3
    counted = result.pop("_counted")
    print(json.dumps({"counted": counted}), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
