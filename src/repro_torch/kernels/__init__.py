"""Hand-written CUDA kernels for the port, each beside its plain PyTorch
version:

  * schedule_sim — Algorithm-2 swarm-fitness replay for PSO-GA
    (``csrc/schedule_sim.cu``; port of the Pallas kernel
    ``repro/kernels/schedule_sim.py``)
  * traffic_sim — queue-aware FCFS replay of R request copies per
    Monte-Carlo arrival draw for the traffic fitness
    (``csrc/traffic_sim.cu``; port of ``repro/kernels/traffic_sim.py``)
  * flash_attention — causal / sliding-window GQA flash prefill
    (``csrc/flash_attention.cu``; port of
    ``repro/kernels/flash_attention.py``)
  * decode_attention — one-token flash decode over a KV cache
    (``csrc/decode_attention.cu``; port of
    ``repro/kernels/decode_attention.py``)
  * ssd_scan — the intra-chunk SSD quadratic form of Mamba2
    (``csrc/ssd_scan.cu``; port of ``repro/kernels/ssd_scan.py``)

``_build.SOURCES`` lists every ``csrc/<name>.cu``; each is wrapped by the
module ``<name>.py``. ``csrc/replay_common.cuh`` holds what the two replay
kernels share: the carry-free first pass, the walk's geometry and the
``cp.async`` helpers. ``ops`` holds the attention and SSD kernels'
wrappers in the model's layout.

Each module's dispatch (``schedule_replay``, ``traffic_replay``,
``flash_attention_folded``, ``decode_attention_folded``,
``ssd_intra_folded``) runs on the
tensors' device and carries the kernel's ``launches`` counter.
``core.traffic.traffic_replay`` is a different, higher-level function: it
replays ONE plan against Monte-Carlo draws and reaches the kernel through
``core.traffic.simulate_traffic_swarm``.

Kernels are compiled with ``nvcc`` on first launch (``_build.py``); a CPU
tensor takes the plain version and never needs the toolkit.
"""
