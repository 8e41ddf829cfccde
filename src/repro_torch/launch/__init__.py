"""Launch-side tooling of the port.

* ``audit`` — ``check_cluster_locality`` (from a ``torch.profiler`` trace
  of a clustered call, does every per-core intermediate stay core-local
  but for the one combine?) and the fusion audits ``check_fusion`` /
  ``check_dag_fusion`` (is a fused program's intermediate buffer gone?);
* ``steps`` — the train step (gradient-accumulated, its state; and
  sharded over a mesh) and the serving path's prefill and decode steps;
* ``serve`` — batched serving and its command line (``python -m
  repro_torch.launch.serve``);
* ``train`` — the checkpointed, fault-tolerant training loop and its
  command line (``python -m repro_torch.launch.train``, ``--mesh d,m``);
* ``mesh`` — device meshes and the rank launcher (``run_ranks``);
* ``dryrun`` — one rank of the production meshes, per (arch × shape)
  cell: its bytes, FLOPs and collectives;
* ``hlo_analysis`` — the reference's HLO text parser (standard library
  only), with the audits' names.

Import submodules explicitly; this
package root stays import-free.
"""
