"""Machine-readable history of the port's bench runs (mirror of
targetvae_tpu/utils/bench_log.py, without its BENCH_NOTES.md splice).

tools/bench_config_torch.py appends each run's JSON result to
bench_results_torch.jsonl at the repository's root, or to the path its
caller gives, through record(), which stamps the entry with the time and
with the card's name and power limit as nvidia-smi reports them (null for a
run on the CPU). A history entry is keyed by its config, batch, compute
dtype and encoder tier (history_key), so that runs differing in any of them
keep their own rows. Nothing here writes the JAX package's
bench_results.jsonl or BENCH_NOTES.md.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
from typing import Dict, List, Optional, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS_PATH = os.path.join(REPO_ROOT, "bench_results_torch.jsonl")

KEY_FIELDS = ("config", "batch", "dtype", "tier")


def card_stamp() -> Dict[str, Optional[str]]:
    """{"card": name, "power_limit": "700.00 W"} of the first card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them; both None where nvidia-smi is missing or reports no card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    lines = out.strip().splitlines()
    if not lines or "," not in lines[0]:
        return {"card": None, "power_limit": None}
    name, limit = lines[0].rsplit(",", 1)
    return {"card": name.strip(), "power_limit": limit.strip()}


def history_key(entry: Dict) -> Tuple:
    """(config, batch, dtype, tier): the fields a history row is kept by."""
    return tuple(entry[k] for k in KEY_FIELDS)


def record(entry: Dict, path: Optional[str] = None) -> Dict:
    """Append one bench result to the history (path, or RESULTS_PATH) and
    return it as written. The entry must carry every field of KEY_FIELDS;
    record adds the time ("ts") and, unless the entry ran on the CPU
    (entry["device"] == "cpu") or carries them already, the card's name and
    power limit (card_stamp); a CPU run records both as None."""
    missing = [k for k in KEY_FIELDS if k not in entry]
    if missing:
        raise ValueError(f"bench entries must carry {missing}")
    entry = dict(entry)
    entry.setdefault(
        "ts", datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"))
    if "card" not in entry or "power_limit" not in entry:
        stamp = ({"card": None, "power_limit": None}
                 if entry.get("device") == "cpu" else card_stamp())
        for k, v in stamp.items():
            entry.setdefault(k, v)
    with open(path or RESULTS_PATH, "a") as f:
        f.write(json.dumps(entry) + "\n")
    return entry


def load_history(path: Optional[str] = None) -> List[Dict]:
    path = path or RESULTS_PATH
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def latest_per_config(path: Optional[str] = None) -> Dict[Tuple, Dict]:
    """Newest entry per history_key (file order; later lines win)."""
    latest: Dict[Tuple, Dict] = {}
    for entry in load_history(path):
        latest[history_key(entry)] = entry
    return latest


def render_table(latest: Dict[Tuple, Dict]) -> str:
    """A markdown table of the newest entries, in key order; MFU "-" for a
    run without one (the CPU)."""
    lines = [
        "| config | batch | dtype | tier | ms/step | images/sec | TFLOP/step "
        "| MFU | card |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(latest, key=lambda k: tuple(map(str, k))):
        e = latest[key]
        mfu = "-" if e.get("mfu") is None else f"{e['mfu'] * 100:.1f}%"
        card = ("cpu" if e.get("card") is None
                else f"{e['card']}, {e['power_limit']}")
        lines.append(
            f"| {e['config']} | {e['batch']} | {e['dtype']} | {e['tier']} "
            f"| {e['ms_per_step']:.2f} | {e['images_per_sec']:.1f} "
            f"| {e['tflops_per_step']:.3f} | {mfu} | {card} |")
    return "\n".join(lines)
