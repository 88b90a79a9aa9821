"""The benchmark of tpunerf_torch on one H100: graphed SDS training in the
cells of BENCHMARK.json, each judged against a plain PyTorch reference."""
