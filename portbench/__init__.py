"""The benchmark of the PyTorch port (`repro_torch`): `run.py` runs one
cell of ``BENCHMARK.json`` once on the card."""
