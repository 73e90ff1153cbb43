"""Multi-view and multi-process training (port of
``triangle_splatting_tpu/parallel``): camera data parallelism over
``torch.distributed`` (``mesh``, ``multihost``), depth-sharded rendering
(``depth_sharded``) and the data x depth hybrid step (``hybrid``)."""
