"""Autolabeling: training-label generation without human annotation
(counterpart of ``treedetection_tpu/autolabel``).

* ``voronoi`` — nDSM-only crown labels (reference
  ``supplementary/pretraining_generate_voronoi.py``)
* ``boxes`` — box-prompted crown cleaning used with SAM-style mask generators
  (reference ``supplementary/segment_annotations.py``)
* ``sam`` — concrete mask generators: ``SamMaskGenerator`` (segment_anything
  torch adapter, import-gated) and ``region_grow_mask_generator`` (first-party,
  dependency-free fallback)
* ``cambridge`` — per-image autolabel + evaluation flow (reference
  ``supplementary/segment_evaluation_cambridge.py``)
"""

from treedetection_tpu_torch.autolabel.voronoi import generate_voronoi_labels  # noqa: F401
from treedetection_tpu_torch.autolabel.boxes import autolabel_image, clean_crowns  # noqa: F401
from treedetection_tpu_torch.autolabel.sam import (  # noqa: F401
    SamMaskGenerator, generate_region_grow_labels, region_grow_mask_generator)
from treedetection_tpu_torch.autolabel.cambridge import (  # noqa: F401
    autolabel_and_evaluate, process_directory as autolabel_directory)
