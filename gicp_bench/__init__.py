"""The benchmark of small_gicp_tpu_torch on NVIDIA GPUs: ``python3
gicp_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the repository's root."""
