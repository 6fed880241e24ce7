"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The last
line of standard output is the result (JSON); the numbers that decided
`correct` end standard error, each beside its limit. Exits non-zero, with
no result, without the cards the cell asks for, or if jax, jaxlib, flax or
ngp_tpu (the JAX package) was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ngp_tpu")


def launch_time() -> float:
    """When this process started (its start in /proc, else this module's)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        boot = next(float(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines() if line.startswith("btime"))
        return min(T_START, boot + int(fields[19]) / ticks)
    except (OSError, StopIteration, ValueError, IndexError):
        return T_START


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_launch = launch_time()

    sys.path.insert(0, str(ROOT))
    cache = ROOT / "build" / "portbench" / "cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    from portbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), this machine has {n}", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    from portbench.harness.cell import run_cell

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_launch)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; the port's benchmark imports no JAX", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        limit = "none (not compared)" if c["limit"] is None else repr(c["limit"])
        print(f"check {name} {c['value']!r} limit {limit}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
