"""vobench: the benchmark of odometry_torch (see BENCHMARK.json and PERF.md).

``python3 vobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell on the card and prints one JSON line. Everything that belongs
to one configuration, traffic mix or metric is a file of its own, found by
the name ``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``metrics/<metric>.py``, ``limits/<cell>.json``.
"""
