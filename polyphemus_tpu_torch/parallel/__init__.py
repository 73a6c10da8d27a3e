"""Data parallelism over `torch.distributed` (`mesh.py`)."""
