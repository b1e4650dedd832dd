"""The benchmark of the PyTorch and CUDA port (see ``portbench/run.py``)."""
