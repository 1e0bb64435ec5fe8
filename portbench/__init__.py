"""The benchmark of ``onebit_tpu_torch``, the PyTorch and CUDA port, on
H100s: ``python3 portbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` (see ``harness.py``)."""
