"""The benchmark of celestia_app_tpu_torch on NVIDIA H100 cards.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. The harness is driven by data: a cell names a
configuration (``configs/<name>.json``), a traffic mix
(``traffic/<name>.json``) and metrics, each read by a file of its own
(``e2e/<name>.py``, ``metrics/<name>.py``); device time is placed on
layers by ``layers/<name>.json``. ``reference/`` is the plain reference
that decides ``correct``; it imports nothing of the program.
"""
