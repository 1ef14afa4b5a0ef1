"""Scale-out of inference: the devices a Predictor splits its batches
over, and the per-host slice of a multi-host run.

Counterpart of ``treedetection_tpu/parallel``:

* **within a process**: each tile batch splits into equal chunks over the
  devices of :func:`make_mesh`, one model replica, one CUDA stream and one
  long-lived thread per device (:func:`sharded_forward`,
  :func:`device_executor`); tiles are independent, so no collective is
  needed;
* **across hosts**: the *file list* partitions by host id
  (:func:`partition_files`), each host writing sharded recovery manifests
  (``recoveries._shard_suffix``).  Data moves through shared storage;
  ``torch.distributed`` over gloo carries only host metadata (barriers and
  two int64 totals).

Training over several devices needs collectives (the gradient, and batch
norm's statistics in both passes), so its mesh is not this device list but
a ``torch.distributed`` process group with one process per device, which
the caller creates: ``train.train.make_sharded_train_step`` and
``train_model(..., mesh=group)``.  One process's autograd engine runs a
device's backward on one thread, where replicas that wait for each other at
an exchange would block it; separate processes each have their own.
"""

from treedetection_tpu_torch.parallel.mesh import (  # noqa: F401
    current_host_id, current_num_hosts, device_executor, dispatch_executor,
    ensure_distributed, make_mesh, partition_files, process_count,
    process_index, replicate, shard_batch, sharded_forward)
