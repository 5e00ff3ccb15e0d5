"""Parallelism of the port on torch.distributed (port of fastdm_tpu/parallel/):
the (dp, sp, tp[, pp]) mesh and its process groups (mesh.py), ring attention
over the sp axis (context_parallel.py), the GPipe schedule over the pp axis
(pipeline.py), tensor parallelism over the tp axis (tensor_parallel.py: the
column / row splits of the blocks' QLinears and the row-parallel forward),
the process-wide sp / pp state the engine sets while it generates
(cp_state.py, pp_state.py), and the host residency of the inactive
Wan2.2-A14B expert (offload.py)."""
