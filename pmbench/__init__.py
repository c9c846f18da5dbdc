"""The benchmark of ``repro_torch``, the PyTorch / CUDA port.

``python -m pmbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line (see ``pmbench.harness``).  The yardstick lives here:
the log generator (``gen``), the traffic generator (``traffic``), the
plain reference and the comparison (``reference``, ``verbs/``), the
card's peaks (``peaks``) and the trace's reduction (``trace``,
``metrics/``).  Nothing here imports JAX or the JAX package ``repro``.
"""
