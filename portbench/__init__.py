"""The benchmark of the PyTorch/CUDA port (``repro_torch``): cells named in
``BENCHMARK.json``, run by ``python3 portbench/run.py --workload <cell>``.

Everything that measures or judges lives here and is read by name: the
configurations (``configs/<name>.json``), the traffic mixes
(``mixes/<name>.json``, each naming its runner in ``runners/``), the
per-layer metric readers (``metrics/<name>.py``), each cell's limits
(``limits/<cell>.json``), the plain f32 reference (``reference/``), the
seeded weights, the FLOP and byte counts and the published peaks.  Only
``port.py`` and the runners import the program.
"""
