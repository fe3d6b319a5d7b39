"""The benchmark of the PyTorch + CUDA port (`multi_modal_regression_tpu_torch`)
on one NVIDIA H100.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the root of the checkout names the cells; each cell's
configuration (`configs/<name>.json`), traffic mix (`traffic/<name>.json`),
comparison limits (`limits/<cell>.json`) and metric readers
(`metrics/<metric>.py`) are files of their own, found by name. Nothing here
imports JAX or the JAX package; `reference/` imports nothing of the port.
"""
