"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads, makes the weights on the card from ``--seed``, warms up the cell's
own shapes, measures for ``--seconds`` (with ``--trace 1`` a traced window
of at most the mix's ``trace_seconds``, which gives the per-layer
metrics), checks the checked requests' answers against the plain
reference, and prints one JSON line last on standard output. Exits
non-zero, printing no result, without enough CUDA devices, or when JAX or
the JAX package was loaded. ``--control lower`` runs the check's control
instead of the configuration as stated (never in a benchmark run).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "neural_enhanced_super_resolution_tpu",
             "nesr"}


def _environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    libraries kept from loading JAX."""
    build = os.path.join(ROOT, "build")
    os.environ["NESR_TORCH_BUILD_DIR"] = os.path.join(build, "torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(build, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("lower",), default=None)
    args = ap.parse_args(argv)
    _environment()
    # the checkout's root, not this folder, is where imports start
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path[0] = ROOT
    else:
        sys.path.insert(0, ROOT)
    from portbench import harness
    cell = harness.load_cell(args.workload, ROOT)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    result, rows = harness.run(cell, args.seed, args.seconds,
                               bool(args.trace), T_START, "cuda",
                               args.control, log=log)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
