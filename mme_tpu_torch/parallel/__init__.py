"""The parallel axes: the multi-process runtime (``distributed.py``), the
mesh of ranks with its collectives (``mesh.py``), per-rank input sharding
(``data.py``) and a pool of ranks for tests and drivers (``launch.py``).
Sequence parallelism is ``ops/ring_attention.py``."""
