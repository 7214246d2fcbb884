"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the harness,
its traffic, configurations, limits, metric readers and plain references.
Run one cell with ``python3 bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root, on a machine with
an NVIDIA GPU."""
