"""Hand-written CUDA kernels for the port, each beside its plain PyTorch
version:

  * schedule_sim — Algorithm-2 swarm-fitness replay for PSO-GA
    (``csrc/schedule_sim.cu``; port of the Pallas kernel
    ``repro/kernels/schedule_sim.py``)

Kernels are compiled with ``nvcc`` on first launch (``_build.py``); a CPU
tensor takes the plain version and never needs the toolkit.
"""
