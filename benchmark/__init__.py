"""The benchmark of passiveradar_torch: ``python3 benchmark/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` (see run.py)."""
