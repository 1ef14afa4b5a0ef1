"""Command-line interface of the PyTorch/CUDA port.

Counterpart of the JAX package's ``cli.py``, for the stages that are
ported::

    treedetection-torch run         config.yml    # full pipeline
    treedetection-torch preprocess  config.yml    # stage 1 only
    treedetection-torch predict     config.yml    # stage 2 only
    treedetection-torch postprocess config.yml    # stage 3 only

(or ``python -m treedetection_tpu_torch.cli ...``).  The config's ``device``
key picks the torch device (default ``cuda``).  The JAX package's other
subcommands (``eval``, ``voronoi``, ``autolabel``, ``bench``) are not ported
yet: they print which roadmap item brings them and exit with code 2.
"""

from __future__ import annotations

import argparse
import sys

# subcommand -> the ROADMAP.md Queue 1 item that ports it
UNPORTED = {
    "eval": "item 16 (autolabel, eval and the utilities)",
    "voronoi": "item 16 (autolabel, eval and the utilities)",
    "autolabel": "item 16 (autolabel, eval and the utilities)",
    "bench": "item 12 (the H100 bench)",
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="treedetection-torch",
        description="Tree-crown detection pipeline, PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="command", required=True)

    for name, help_text in (
            ("run", "full pipeline: preprocess -> predict -> postprocess"),
            ("preprocess", "tiling + overlap merging only"),
            ("predict", "model inference + stitching only"),
            ("postprocess", "crown filtering only")):
        p = sub.add_parser(name, help=help_text)
        p.add_argument("config", help="YAML config path")

    for name, item in UNPORTED.items():
        p = sub.add_parser(name, help=f"not ported yet: ROADMAP.md Queue 1 "
                                      f"{item}")
        p.add_argument("args", nargs=argparse.REMAINDER)

    args = parser.parse_args(argv)

    if args.command in UNPORTED:
        print(f"treedetection-torch {args.command}: not ported yet; it comes "
              f"with ROADMAP.md Queue 1 {UNPORTED[args.command]}. The JAX "
              f"package's 'treedetection {args.command}' still works.",
              file=sys.stderr)
        return 2

    from treedetection_tpu_torch.config import get_config
    from treedetection_tpu_torch import detection
    config, _ = get_config(args.config)
    fn = {"run": detection.process_files,
          "preprocess": detection.preprocess_files,
          "predict": detection.predict_tiles,
          "postprocess": detection.postprocess_files}[args.command]
    outputs = fn(config)
    for out in outputs or []:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
