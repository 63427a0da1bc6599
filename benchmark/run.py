"""One run of one benchmark cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (from this process's start: imports, the card, the seeded inputs
and weights, the port's objects, the checked first steps, the warm-up of
every shape the window uses) is setup_s. The window then runs for
--seconds and ends in a synchronise; --trace 1 runs it under
torch.profiler and reports the cell's per-layer metrics instead of its
end-to-end ones. After the window the program is freed and its outputs are
held against the reference (judge.py). The last line of standard output is
one JSON object: correct, attempted, failed, metrics, device, with --trace
1 breakdown, and last the numbers compared with their limits ("checks"),
which are also the last lines of standard error. Without a CUDA device, or
with fewer than the cell asks for, or without the port in the checkout,
it exits 2 and prints no result; with JAX or the JAX package loaded, 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))

from benchmark import guard, spec  # noqa: E402


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float) -> dict:
    """One run of `cell` on `device`: the result line's object."""
    import torch

    from benchmark import drive, judge
    from benchmark import trace as tracing

    marks = [("imports", time.perf_counter())]
    d = drive.prepare(cell, seed, device)
    marks += d.marks
    prog = d.check_steps()
    marks.append(("checked steps", time.perf_counter()))
    d.warm_up()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    print("# setup_s " + ", ".join(
        f"{name} {b - a:.2f}" for (name, b), (_, a)
        in zip(marks, [("start", t0)] + marks)), file=sys.stderr)
    if trace:
        with tracing.profiler() as prof:
            w = d.window(seconds)
    else:
        w = d.window(seconds)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    result = {"correct": False, "attempted": w.attempted,
              "failed": w.failed}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        t = tracing.from_profiler(prof)
        del prof
        t.run = w
        for seconds, name, chain in t.top_ops():
            print(f"# device {seconds:.4f} s {name[:90]} <- "
                  f"{' < '.join(chain[:4])}", file=sys.stderr)
        values = {m["name"]: spec.metric_reader(m["name"], cell.root).read(t)
                  for m in cell.per_layer}
    else:
        # a name's part before its first dot says what it measures; the
        # rest, which cells share its bound
        values = drive.end_to_end(w, setup_s)
        values = {m["name"]: values.get(m["name"].split(".", 1)[0])
                  for m in cell.end_to_end}
    result["metrics"] = {k: {"value": v, "unit": units[k]}
                         for k, v in values.items() if v is not None}
    result["device"] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = t.breakdown()
    guard.check("after the window")
    numbers = d.numbers(prog)
    ok, checks = judge.verdict(numbers, cell.limits)
    result["correct"] = ok and w.failed == 0 and w.attempted > 0
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    guard.check("start")
    cell = spec.load_cell(args.workload)
    if not (ROOT / spec.PORT / "__init__.py").is_file():
        print(f"# no {spec.PORT} beside the benchmark in {ROOT}: no result",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"# {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T0)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
