"""Readings from which a cell's limits are set: the program's over many
seeds and the control's (the reference in a lower precision put in the
program's place) over the first few, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> \
        --controls <k> --seconds <s> [--out <dir>]

Each seed runs the cell's driver as a run does (a window of ``--seconds``),
then prints one JSON line: the seed, the program's readings and, for the
first ``--controls`` seeds, the control's and those of the faults the
driver plants (its ``faults``, where it has one). The lines also go to ``<out>/calibrate_<cell>.jsonl`` (default
``build/calibrate``, inside the checkout). Runs on the card only.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from benchmark.harness import env, registry  # noqa: E402


def main(argv=None, device=None, root=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=7_000_000_001)
    p.add_argument("--out", default=os.path.join("build", "calibrate"))
    args = p.parse_args(argv)
    root = root or env.checkout_root()
    env.set_cache_dirs(root)
    spec = registry.load_spec(root)
    cell = registry.find_cell(spec, args.workload)
    import torch
    if device is None and not torch.cuda.is_available():
        print("calibrate: no CUDA device is available", file=sys.stderr)
        return 2
    config = registry.load_config(root, spec, cell["config"])
    traffic = registry.load_traffic(root, cell["traffic"])
    drv = registry.driver(traffic)
    seeds = np.random.default_rng(args.first_seed).integers(
        2**31, 2**33, size=args.seeds).tolist()
    out_dir = os.path.join(root, args.out)
    os.makedirs(out_dir, exist_ok=True)
    lines = []
    for k, seed in enumerate(seeds):
        ctx = SimpleNamespace(
            root=root, cell=cell, config=config, traffic=traffic, seed=seed,
            seconds=args.seconds, trace=False,
            device=torch.device(device or "cuda"), t_start=time.perf_counter())
        out = drv.run(ctx)
        line = {"seed": seed, "program": out["readings"],
                "attempted": out["attempted"], "e2e": out["e2e"]}
        if k < args.controls:
            line["control"] = drv.control(ctx, out)
            if hasattr(drv, "faults"):
                line["faults"] = drv.faults(ctx, out)
        del out
        lines.append(line)
        print(json.dumps(line), flush=True)
    with open(os.path.join(out_dir, f"calibrate_{cell['name']}.jsonl"),
              "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
