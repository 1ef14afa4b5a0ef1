"""Command-line interface of the PyTorch/CUDA port.

Counterpart of the JAX package's ``cli.py``::

    treedetection-torch run         config.yml       # full pipeline
    treedetection-torch preprocess  config.yml       # stage 1 only
    treedetection-torch predict     config.yml       # stage 2 only
    treedetection-torch postprocess config.yml       # stage 3 only
    treedetection-torch eval PRED.gpkg GT.gpkg       # score an output layer
    treedetection-torch voronoi NDSM.tif OUT.gpkg    # nDSM autolabels
    treedetection-torch autolabel IMGDIR ANNDIR OUT  # box-prompted autolabel+eval
    treedetection-torch bench                        # tiles/s of model + pipeline

(or ``python -m treedetection_tpu_torch.cli ...``).  The config's ``device``
key picks the torch device of the pipeline stages (default ``cuda``);
``voronoi`` takes ``--device`` (default ``cuda``) for its seed search,
``autolabel`` for the SAM model of ``--sam-checkpoint``, and ``bench``
for the whole bench (``--device cpu``: its small CPU configuration).
"""

from __future__ import annotations

import argparse
import json
import sys


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

    p = sub.add_parser("eval", help="score predictions against annotations")
    p.add_argument("predictions", help="processed crowns GPKG")
    p.add_argument("ground_truth", help="annotation GPKG")
    p.add_argument("--iou", type=float, default=0.5)
    p.add_argument("--confidence", type=float, default=0.3)

    p = sub.add_parser("voronoi", help="generate nDSM Voronoi autolabels")
    p.add_argument("ndsm", help="nDSM GeoTIFF")
    p.add_argument("output", help="output GPKG")
    p.add_argument("--canopy-threshold", type=float, default=2.5)
    p.add_argument("--min-seed-height", type=float, default=3.0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the seed search (default cuda)")

    p = sub.add_parser("autolabel",
                       help="Cambridge-style per-image autolabel + eval "
                            "(box prompts from annotations)")
    p.add_argument("image_dir", help="directory of .tif images")
    p.add_argument("annotation_dir", help="directory of per-image .gpkg")
    p.add_argument("out_dir", help="output directory for autolabel GPKGs")
    p.add_argument("--sam-checkpoint",
                   help="segment_anything checkpoint (default: first-party "
                        "region-grow generator)")
    p.add_argument("--sam-model-type", default="vit_h")
    p.add_argument("--device", default="cuda",
                   help="torch device of the SAM model (default cuda)")

    p = sub.add_parser("bench", help="tile throughput of the model and of "
                                     "process_files (one JSON line)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the bench (default cuda; cpu runs "
                        "its small CPU configuration)")

    args = parser.parse_args(argv)

    if args.command == "bench":
        from treedetection_tpu_torch.bench import main as bench_main
        return bench_main(["--device", args.device])

    if args.command == "eval":
        from treedetection_tpu_torch.eval.validation import evaluate_gpkg_pair
        metrics = evaluate_gpkg_pair(args.predictions, args.ground_truth,
                                     args.iou, args.confidence)
        print(json.dumps(metrics, indent=1))
        return 0

    if args.command == "voronoi":
        from treedetection_tpu_torch.autolabel import generate_voronoi_labels
        n = generate_voronoi_labels(args.ndsm, args.output,
                                    canopy_threshold=args.canopy_threshold,
                                    min_seed_height=args.min_seed_height,
                                    device=args.device)
        print(f"{n} crowns -> {args.output}")
        return 0

    if args.command == "autolabel":
        import logging
        logging.basicConfig(level=logging.INFO)
        gen = None
        if args.sam_checkpoint:
            from treedetection_tpu_torch.autolabel import SamMaskGenerator
            gen = SamMaskGenerator(args.sam_checkpoint,
                                   model_type=args.sam_model_type,
                                   device=args.device)
        from treedetection_tpu_torch.autolabel import autolabel_directory
        rows = autolabel_directory(args.image_dir, args.annotation_dir,
                                   args.out_dir, mask_generator=gen,
                                   logger=logging.getLogger("autolabel"))
        print(json.dumps(rows, indent=1))
        return 0

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
