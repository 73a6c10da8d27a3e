from .dataset import (BatchLoader, PolyphemusDataset,  # noqa: F401
                      synthetic_batch, write_sample)
