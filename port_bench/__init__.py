"""The benchmark of the PyTorch/CUDA port (``vn_pointcloudcompletion_tpu_torch``)
on one NVIDIA H100: ``python3 port_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  See ``PERF.md`` at the root of the repo."""
