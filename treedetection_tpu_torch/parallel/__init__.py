"""Scale-out: the devices a Predictor splits its batches over, and the
per-host slice of a multi-host run.

Counterpart of ``treedetection_tpu/parallel``:

* **within a process**: each tile batch splits into equal chunks over the
  devices of :func:`make_mesh`, one model replica and one CUDA stream per
  device (:func:`sharded_forward`); tiles are independent, so no collective
  is needed;
* **across hosts**: the *file list* partitions by host id
  (:func:`partition_files`), each host writing sharded recovery manifests
  (``recoveries._shard_suffix``).  Data moves through shared storage;
  ``torch.distributed`` over gloo carries only host metadata (barriers and
  two int64 totals).
"""

from treedetection_tpu_torch.parallel.mesh import (  # noqa: F401
    current_host_id, current_num_hosts, ensure_distributed, make_mesh,
    partition_files, process_count, process_index, replicate, shard_batch,
    sharded_forward)
