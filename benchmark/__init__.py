"""The benchmark of the PyTorch and CUDA port (``mysteryann_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything a cell needs is found by name: its configuration
(``configs/<config>.json``), the engine adapter the configuration names
(``engines/<engine>.py``, the only files that import the port), its plain
reference (``reference/<reference>.py``), its traffic mix
(``traffic/<mix>.json``) and one reader per metric (``metrics/<metric>.py``).
"""
