"""Tools of the port, each run as ``python -m dpfx_torch.tools.<name>``; each
tool that builds a model takes ``--device`` (cuda by default, ``cpu`` for
the plain versions) and the measurement tools print their kernel launches
last.

Measurement (counterparts of the JAX package's ``tools/``):
  ``bench_kernels``      each kernel against its plain twin, one JSON line
  ``bench_serving``      sampler latency and throughput against the batch size
  ``bench_batch_sweep``  train-step time and MFU against the batch size
  ``bench_sample_int8``  the int8 sampler against bf16, with its error
  ``prof_train``         the train step cut into pieces, each replayed alone
  ``parse_trace``        per-kernel device time from a ``utils.profiling.trace``
  ``bench_fused_bwd``    the point-flow backward's decomposition probe
  ``probe_dual_issue``   the dual-issue probe
Data and quality:
  ``quality_oracle``          the train-vs-test and noise-vs-test brackets
  ``make_synthetic_shapenet`` a ShapeNet-layout tree (renders, HDF5) of the
                              synthetic family
  ``part_count_pin``          the v3 chain kind's part-count coverage
  ``pack_dataset``            the native loader's packed stack
Build checks: ``sass_loops`` (element-loop SASS), ``bwd_ab`` (the training
backward against a parent build).
"""
