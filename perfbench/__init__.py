"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything that
belongs to one configuration, traffic mix or per-layer metric sits in
files of its own, found by the name the manifest gives:

  configs/<config>.json     the configuration as it is run; its ``system``
                            names the adapter ``systems/<system>.py``,
                            whose plain reference is
                            ``reference/<system>.py``
  traffic/<traffic>.json    the parameters the adapter's driver reads
  limits/<cell>.json        the limits ``correct`` is decided by
  metrics/<metric>.py       a per-layer metric's reader and its arithmetic

Nothing here imports JAX, the JAX package ``repro`` or ``benchmarks``.
"""
