"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``checks``: each number compared with its
limit); the last lines of standard error repeat the checks. Without
CUDA, with fewer cards than the cell asks for, or when a JAX module was
loaded, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # process start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the port's one compile cache, its nvcc builds, sits at a fixed path
# inside the checkout: hnsw_itu_tpu_torch/build/ (fixed in the program);
# the port launches no Triton kernel


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [ROOT]
    from portbench import harness

    try:
        meta = harness.cell_parts(args.workload)[0]
    except (KeyError, FileNotFoundError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(meta["chips"]):
        print(f"portbench: {args.workload} needs {meta['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {card_line()}",
          file=sys.stderr)
    try:
        import hnsw_itu_tpu_torch  # noqa: F401  the system under test

        result, checks = harness.run(
            args.workload, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), device="cuda:0", t0=T0)
    except ImportError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
