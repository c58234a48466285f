"""The benchmark's harness: cells, weights, the traffic generator, traces
and the comparison that decides ``correct``. Everything a cell needs is
found by name in the files beside it (``configs/``, ``traffic/``,
``workloads/``, and the code of ``loops/``, ``models/`` and
``metrics/``)."""
