"""What a run may not load: JAX, the JAX package, and, in the reference,
the port.

Module names are compared by their whole top-level name (the part before
the first dot): the port's package, targetvae_tpu_torch, begins with the
JAX package's name, targetvae_tpu, and is allowed.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "targetvae_tpu"})
PORT = "targetvae_tpu_torch"
REFERENCE = Path(__file__).resolve().parent / "reference"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(names=None) -> list:
    """The loaded modules (or `names`) whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def imports_of(path: Path) -> set:
    """The top-level names a Python file imports (relative imports are the
    benchmark's own and are left out)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {top_level(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(top_level(node.module))
    return out


def reference_violations(folder: Path = REFERENCE) -> list:
    """(file, module) for each import of the port, JAX or the JAX package
    by the reference's files."""
    return sorted((p.name, m) for p in folder.glob("*.py")
                  for m in imports_of(p) if m in FORBIDDEN | {PORT})


def check(where: str) -> None:
    """Raise SystemExit (no result printed) if a forbidden module is loaded
    or the reference imports the port; names what it found on stderr."""
    found = forbidden_modules()
    bad = reference_violations()
    if found or bad:
        print(f"# {where}: forbidden modules loaded {found}; reference "
              f"imports {bad}", file=sys.stderr)
        raise SystemExit(3)
