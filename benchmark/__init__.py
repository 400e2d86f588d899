"""The benchmark of the PyTorch and CUDA port (``lvc_tpu_torch``) on NVIDIA
H100 cards: ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.
It imports neither JAX nor the JAX package."""
