"""Benchmark of the PyTorch/H100 port (``active_3d_vision_and_touch_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name that ``BENCHMARK.json``
gives it: ``configs/<config>.json``, ``traffic/<mix>.json`` (whose
``runner`` names a module of ``runners/``), ``limits/<cell>.json`` and
``metrics/<metric>.py``.  ``reference/`` is the plain PyTorch reference
that decides ``correct``; it imports nothing of the port.
"""
