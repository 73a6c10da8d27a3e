from .dataset import (BatchLoader, PolyphemusDataset,  # noqa: F401
                      load_sample, shard_rows, synthetic_batch, write_sample)
