"""Tools of the port: the measurement tools, counterparts of the JAX
package's ``tools/bench_fused_bwd.py`` and ``tools/probe_dual_issue.py``,
each over its own hand-written CUDA kernel (``dpfx_torch/ops/csrc/``), and
``pack_dataset``, which writes the native loader's packed stack."""
