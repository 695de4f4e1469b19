"""The benchmark of the PyTorch and CUDA port (`healthivert_tpu_torch`): one
run of a cell is `python3 -m hv_bench.run` (see run.py)."""
