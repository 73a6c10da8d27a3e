from .dataset import (BatchLoader, PolyphemusDataset,  # noqa: F401
                      load_sample, synthetic_batch, write_sample)
