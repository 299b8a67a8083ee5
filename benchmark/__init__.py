"""The benchmark of cfdtpu_torch on the card: `python benchmark/run.py`."""
