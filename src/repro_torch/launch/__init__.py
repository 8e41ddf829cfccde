"""Launch-side tooling of the port.

* ``audit`` — ``check_cluster_locality``: from a ``torch.profiler`` trace
  of a clustered call, does every per-core intermediate stay core-local
  but for the one combine?

The reference's ``launch`` package also holds the mesh, the train/serve
steps and the dry-run (port slice 9) and, beside its HLO cluster audit,
the fusion audits and the HLO parser (port slice 8).  Import submodules
explicitly; this package root stays import-free.
"""
