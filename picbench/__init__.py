"""The benchmark of vpic_tpu_torch on one NVIDIA H100 (``python3
picbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``;
see README.md)."""
