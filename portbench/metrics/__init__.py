"""Per-layer metrics: one reader per file, ``read(record) -> float | None``.

``record`` is what the traced run gathered (see ``portbench/harness.py``):
``events`` (the reduced trace of the profiled slice, ``portbench/trace.py``),
``slice_steps`` and ``slice_wall_s``, ``step_wall_s`` (wall time per step
of the window outside the slice), ``flops_per_step`` and the SOAP kernels'
``soap_fwd_work`` / ``soap_bwd_work`` (bytes, operations) per call.  A
reader that finds nothing to read returns None and the metric is left out
of the line."""
