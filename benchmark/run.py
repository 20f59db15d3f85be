"""Run one cell of the benchmark and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration and traffic mix; the traffic file names its driver
(``benchmark/drivers/``), which builds the port's objects, makes the inputs
and weights from ``--seed``, warms up, measures for ``--seconds`` seconds,
and checks what the timed path produced against the plain reference
(``benchmark/reference/``). With ``--trace 0`` the result holds the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read by
``benchmark/metrics/<name>.py`` from the spans and the trace, the device's
busy seconds and a breakdown.

The last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` with
``--trace 1``, and last ``checks``: each number compared with its limit);
the last lines on standard error list the same checks. Without a card, with
fewer cards than the cell asks for, without the port, or with a JAX module
loaded, it prints no result and exits with another code than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from benchmark.harness import env, registry  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None, device=None, root=None, t_start=None):
    """Run a cell; returns the exit code. ``device`` (a test's ``"cpu"``)
    skips the look for a card; ``root`` is the checkout."""
    args = parse(argv)
    root = root or env.checkout_root()
    env.set_cache_dirs(root)
    spec = registry.load_spec(root)
    cell = registry.find_cell(spec, args.workload)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return _fail("no CUDA device is available")
        if torch.cuda.device_count() < cell["chips"]:
            return _fail(f"the cell asks for {cell['chips']} cards, "
                         f"{torch.cuda.device_count()} available")
        device = "cuda"
    try:
        import srbh_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the program is not in this checkout ({e})")
    config = registry.load_config(root, spec, cell["config"])
    traffic = registry.load_traffic(root, cell["traffic"])
    ctx = SimpleNamespace(
        root=root, cell=cell, config=config, traffic=traffic,
        seed=args.seed & (2**63 - 1), seconds=args.seconds,
        trace=bool(args.trace), device=torch.device(device),
        t_start=T_START if t_start is None else t_start)
    out = registry.driver(traffic).run(ctx)
    left = multiprocessing.active_children()
    for p in left:
        p.join(timeout=30)
    if any(p.is_alive() for p in left):
        return _fail("the program left processes running", 3)

    loaded = env.forbidden_loaded()
    if loaded:
        return _fail("forbidden modules were loaded: " + ", ".join(loaded), 3)

    metrics = {}
    for m in registry.cell_metrics(spec, cell["name"], ctx.trace):
        if ctx.trace:
            value = registry.metric_reader(root, m["name"])(out["record"])
        else:
            value = out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if ctx.device.type == "cuda"
                    else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if ctx.trace:
        tr = out["record"].get("trace")
        if not tr:
            return _fail("the traced run profiled nothing", 3)
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out["checks"].items()}
    for note in out.get("notes", ()):
        print(f"note: {note}", file=sys.stderr)
    for k, (v, lim) in out["checks"].items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
