"""Shared fixtures of the port's CPU tests: one reference-layout state dict
fed to both packages, and the comparison rules for thresholded masks and
argmax ids.

Weights come from `torch_ref.random_state_dict` -> `convert_state_dict`
(numpy) -> the JAX variables and, through `from_jax_variables`, the port's
state dict.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from polyphemus_tpu.config import ModelConfig
from polyphemus_tpu.convert import convert_state_dict
from polyphemus_tpu.models import VAE
from polyphemus_tpu_torch.config import ModelConfig as PModelConfig
from polyphemus_tpu_torch.convert import from_jax_variables
from polyphemus_tpu_torch.models import VAE as PVAE

from . import torch_ref

# The suite runs in several worker processes on one host; torch's default of
# one intra-op thread per core in each of them would oversubscribe the cores
# and starve the timing-sensitive tests of other files.
torch.set_num_threads(1)

# structure logits this close to 0 may threshold differently in the two
# frameworks (fp32 rounding of the same math)
S_LOGIT_TIE = 1e-3
# argmax ids may differ where the top-2 logit gap is below this
LOGIT_TIE = 1e-4


def small_cfg(batch_norm=True, d=32, n_layers=3, gcl_chain=1, n_bars=2):
    return ModelConfig(d=d, gnn_n_layers=n_layers, n_bars=n_bars,
                       resolution=8, dropout=0.0, batch_norm=batch_norm,
                       gcl_chain=gcl_chain)


def port_cfg(cfg: ModelConfig) -> PModelConfig:
    names = {f.name for f in dataclasses.fields(PModelConfig)}
    return PModelConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                           if k in names})


def build(cfg: ModelConfig, seed=0):
    """(numpy JAX variables, JAX VAE, port VAE on the CPU in eval mode)."""
    sd = torch_ref.random_state_dict(cfg, seed=seed)
    variables = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                   cfg)
    model = PVAE(port_cfg(cfg))
    model.load_state_dict(from_jax_variables(variables))
    return variables, VAE(cfg), model.eval()


def jax_tree(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def random_z(b, d, seed=3):
    return np.random.default_rng(seed).standard_normal((b, d)).astype(
        np.float32)


def assert_masks_match(mask_a, mask_b, s_logits):
    """Masks equal wherever the structure logit is clear of 0."""
    mask_a, mask_b = np.asarray(mask_a), np.asarray(mask_b)
    clear = np.abs(np.asarray(s_logits)) > S_LOGIT_TIE
    np.testing.assert_array_equal(mask_a[clear], mask_b[clear])


def top2_gap(logits):
    """Gap between the two largest logits along the last axis."""
    part = np.sort(np.asarray(logits, np.float64), axis=-1)
    return part[..., -1] - part[..., -2]


def assert_ids_match(ids_a, ids_b, c_logits, mask=None, max_tie_frac=1e-3):
    """ids (..., T, S, 15, 2) equal except where the (pitch or dur) top-2
    logit gap of c_logits (..., T, S, 15, 230) is below LOGIT_TIE; such
    cells must be few among the active cells of `mask` (..., T, S) (an
    inactive cell of a model with zero biases ties exactly)."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    c_logits = np.asarray(c_logits)
    gaps = np.stack([top2_gap(c_logits[..., :131]),
                     top2_gap(c_logits[..., 131:])], axis=-1)
    tie = gaps < LOGIT_TIE
    active = tie if mask is None else tie[np.asarray(mask, bool)]
    assert active.mean() <= max_tie_frac, f"too many near-ties: {active.mean()}"
    np.testing.assert_array_equal(ids_a[~tie], ids_b[~tie])


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
