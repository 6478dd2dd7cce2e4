"""The benchmark of the PyTorch/CUDA port ``marl_dmfb_tpu_torch``: cells of
``BENCHMARK.json`` driven from data files (``README.md``)."""
