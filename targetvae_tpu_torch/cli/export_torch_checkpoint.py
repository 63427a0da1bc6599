"""Export a run of this package as the reference's pickled .sav modules
(mirror of tools/export_torch_checkpoint.py):

    python -m targetvae_tpu_torch.cli.export_torch_checkpoint RUN_DIR
    python -m targetvae_tpu_torch.cli.export_torch_checkpoint RUN/inference.sav

It writes inference_torch.sav (and generator_torch.sav for a run
directory) beside the inputs or to --out-dir; the reference's tools
torch.load them and run them with its own forward code
(utils/torch_export.py). It runs on the host.
"""

from __future__ import annotations

import argparse
import sys

from ..utils.torch_export import export_checkpoint


def main(argv=None) -> list:
    """Returns the paths written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("target", help="run dir or checkpoint path")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    written = export_checkpoint(args.target, args.out_dir)
    for path in written:
        print(f"# wrote {path}", file=sys.stderr)
    return written


if __name__ == "__main__":
    main()
