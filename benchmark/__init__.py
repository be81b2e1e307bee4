"""The benchmark of the PyTorch/CUDA port (`vid2player3d_torch`).

`python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once; see `README.md`.
"""
