"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size, many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--window 3] [--out FILE]

For each seed it prepares a run (the same inputs, weights and
port objects as a run of that seed), reads the program's numbers as a run
does (an embed after a short window at the cell's load), every number the
judge reads whether or not the cell's limits compare it, and, on the
control seeds, the control's: the reference in float8 in the program's
place; for a train cell also the planted fault of half of each batch left
out (the reference on the first half of each sampled batch; a state left
unchanged reads 1 on update_gap by the measure itself and needs no run). One JSON line a seed
and reading, then the lowest and highest of each. Limits are set from
these by hand into limits/<cell>.json, with the readings.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import drive, guard, judge, spec  # noqa: E402


def readings(cell, seed: int, control: bool, window: float, device):
    """{kind: numbers} for one seed: "program", and with `control`
    "control" (and for a train cell "half_batch")."""
    d = drive.prepare(cell, seed, device)
    prog = d.check_steps()
    d.warm_up()
    if cell.traffic["kind"] == "embed":
        d.window(window)
    inputs = d.release()
    out = {}
    if cell.traffic["kind"] == "train":
        refd = judge.reference_steps(**inputs)
        runs = {"program": prog}
        if control:
            runs["control"] = judge.reference_steps(**inputs,
                                                    prec=judge.FP8)
            runs["half_batch"] = judge.reference_steps(**inputs,
                                                       drop_half=True)
        for kind, got in runs.items():
            out[kind] = judge.train_numbers(got, refd)
            # the look: every leaf's gaps
            for reading, gaps in judge.leaf_gaps(got, refd).items():
                out[kind][f"leaves.{reading}"] = gaps
    else:
        out["program"] = judge.embed_numbers(**inputs)
        if control:
            fp8 = judge.reference_answers(
                inputs["params"], inputs["enc"], inputs["images"], device,
                prec=judge.FP8)
            out["control"] = judge.embed_numbers(**{**inputs,
                                                    "answers": [fp8]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--window", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    guard.check("start")
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("# calibrate runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    out = open(args.out, "a") if args.out else None
    for seed in sorted(set(seeds) | controls):
        t = time.perf_counter()
        for kind, numbers in readings(cell, seed, seed in controls,
                                      args.window, device).items():
            row = {"cell": cell.name, "seed": seed, "kind": kind, **numbers}
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        print(f"# seed {seed}: {time.perf_counter() - t:.1f} s",
              file=sys.stderr)
    for kind in sorted({r["kind"] for r in rows}):
        sel = [r for r in rows if r["kind"] == kind]
        names = [k for k in sel[0] if k not in ("cell", "seed", "kind")
                 and not k.startswith("leaves.")]
        print(json.dumps({"cell": cell.name, "kind": kind, "seeds": len(sel),
                          "min": {n: min(r[n] for r in sel) for n in names},
                          "max": {n: max(r[n] for r in sel) for n in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
