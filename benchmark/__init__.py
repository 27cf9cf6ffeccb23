"""The benchmark of posecnn_torch on one NVIDIA H100: `BENCHMARK.json` at the
repository's root names the cells; `python3 -m benchmark.run` runs one."""
