"""Generation engine.

Counterpart of `polyphemus_tpu/generate.py`:
`z -> structure logits -> threshold -> lattice -> content -> token ids` as
one batched device function (`make_generator`), then host-side rendering of
token ids to songs and MIDI files.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; without a card they raise rather than fall back. The decode
runs in fp32 or, with `bf16=True`, in bfloat16 as the JAX package's bf16
generation does.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import json
import os
import shutil
import subprocess
from typing import Optional

import numpy as np
import torch

from . import constants
from .config import GenerationConfig
from .convert import load_model_dir
from .midi.song import Note, Song, Track


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA device when it is None. Raises when no card is
    present and the caller did not ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def load_model(model_dir: str, device=None):
    """(VAE in eval mode on the device, TrainConfig) from a model directory
    of the JAX package (`checkpoint.msgpack`), of the reference (`checkpoint`
    + `configuration`) or of the port (`checkpoint.pt`), detected in that
    order."""
    return load_model_dir(model_dir, resolve_device(device))


def generate_z(seed: int, n: int, d: int, device=None) -> torch.Tensor:
    """z ~ N(0, I) from a seeded `torch.Generator` (its stream differs from
    `jax.random`'s for the same seed)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, d), generator=g, device=dev)


@contextlib.contextmanager
def exact_fp32():
    """Full-fp32 matmuls and cuDNN convolutions (no TF32): one flipped
    structure cell changes every content id downstream. bf16 cuBLAS
    products reduce in fp32, as XLA's do."""
    matmul = torch.backends.cuda.matmul
    prev = (matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        (matmul.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = prev


def _tokens_from_logits(c_logits):
    """Argmax (pitch, dur) ids per slot: (..., 15, 230) -> (..., 15, 2)."""
    pitch = c_logits[..., :constants.N_PITCH_TOKENS].argmax(-1)
    dur = c_logits[..., constants.N_PITCH_TOKENS:].argmax(-1)
    return torch.stack([pitch, dur], dim=-1)


def _placed(model, dev: torch.device) -> bool:
    """True when every parameter and buffer of `model` lies on `dev` (a
    CUDA device without an index is the current one)."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return all(t.device == dev for t in itertools.chain(model.parameters(),
                                                       model.buffers()))


def make_generator(model, *, conditioned: bool = False,
                   return_logits: bool = False, bf16: bool = False,
                   structure_temp: float = 0.0, content_temp: float = 0.0,
                   sample_seed: int = 0, device=None):
    """Build the z -> music function.

    Returns fn(z[, mask]) -> (mask, tokens) (+ (s_logits, c_logits) with
    return_logits): mask (B, nb, T, S) bool, tokens (B, nb, T, S, 15, 2)
    uint8 ids at every cell (callers apply the mask), all on the device.
    z and mask may be numpy arrays or tensors.

    GCL layers run `model.cfg.gcl_chain` per kernel launch, and 2 when that
    is left at 1. At a temperature > 0 one seeded `torch.Generator` draws
    the noise, so successive calls draw fresh noise.

    bf16=True decodes in bfloat16, as the JAX package's bf16 generation
    does: a bf16 copy of the model (every float parameter and buffer, the
    batch-norm running statistics too) on z cast to bf16. The logits come
    back in bf16.

    `model` itself is left as it was (mode, device, dtype): a model that
    is in training mode or off the device is decoded from an eval copy on
    the device; one already in eval mode on the device is used as it is.
    """
    dev = resolve_device(device)
    if bf16:
        model = copy.deepcopy(model).to(dev, torch.bfloat16).eval()
    elif model.training or not _placed(model, dev):
        model = copy.deepcopy(model).to(dev).eval()
    dtype = torch.bfloat16 if bf16 else torch.float32
    chain = model.cfg.gcl_chain if model.cfg.gcl_chain > 1 else 2
    stochastic = structure_temp > 0 or content_temp > 0
    gen = (torch.Generator(device=dev).manual_seed(sample_seed)
           if stochastic else None)

    def run(z, mask=None):
        z = torch.as_tensor(z, dtype=torch.float32, device=dev).to(dtype)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
        with torch.no_grad(), exact_fp32():
            if return_logits:
                s_logits, c_logits, used = model.decode(z, mask,
                                                        gcl_chain=chain)
                tokens = _tokens_from_logits(c_logits).to(torch.uint8)
                return used, tokens, s_logits, c_logits
            _, tokens, used = model.decode_tokens(
                z, mask, structure_temp=structure_temp,
                content_temp=content_temp, generator=gen, gcl_chain=chain)
            return used, tokens.to(torch.uint8)

    if conditioned:
        return lambda z, mask: run(z, mask)
    return lambda z: run(z)


def mtp_from_logits(c_logits: torch.Tensor, mask) -> torch.Tensor:
    """Dense multitrack-pianoroll logits with hard silences at inactive
    cells: pitch EOS one-hot at slot 0, PAD at the other slots. Elsewhere
    the logits pass through, in their dtype and on their device.

    c_logits: (B, nb, T, S, 15, 230); mask: (B, nb, T, S) bool.
    """
    silence = torch.zeros(c_logits.shape[-2:], dtype=c_logits.dtype,
                          device=c_logits.device)
    silence[0, constants.PitchToken.EOS] = 1.0
    silence[1:, constants.PitchToken.PAD] = 1.0
    m = torch.as_tensor(mask, dtype=torch.bool, device=c_logits.device)
    return torch.where(m[..., None, None], c_logits, silence)


# -------------------------------------------------------------------- host render
def song_from_tokens(tokens: np.ndarray, mask: np.ndarray, resolution: int,
                     gen_config: Optional[GenerationConfig] = None) -> Song:
    """One sample's (tokens, mask) -> Song.

    Per track, walk global timesteps and note slots; stop a cell at EOS/PAD
    of pitch or duration; skip SOS pitches (a SOS duration with a valid
    pitch still emits, as in the reference); durations remap [0,95] ->
    [1,96], clamped to the sequence end.
    """
    gen_config = gen_config or GenerationConfig()
    n_bars, n_tracks, n_ts = mask.shape
    total = n_bars * n_ts
    tracks = []
    for t in range(n_tracks):
        name = constants.TRACKS[t]
        is_drum = t == constants.DRUMS_TRACK
        notes = []
        for b in range(n_bars):
            for s in range(n_ts):
                if not mask[b, t, s]:
                    continue
                gt = b * n_ts + s
                for slot in range(tokens.shape[-2]):
                    pitch, dur = tokens[b, t, s, slot]
                    if (pitch in (constants.PitchToken.EOS,
                                  constants.PitchToken.PAD)
                            or dur in (constants.DurationToken.EOS,
                                       constants.DurationToken.PAD)):
                        break
                    if pitch == constants.PitchToken.SOS:
                        continue
                    duration = min(int(dur) + 1, total - gt)
                    notes.append(Note(gt, int(pitch), duration, 64))
        program = gen_config.midi_programs.get(name, 0)
        tracks.append(Track(name=name, is_drum=is_drum,
                            program=0 if is_drum else program, notes=notes))
    return Song(resolution=resolution, tempo=120.0, tracks=tracks)


def load_structure_array(s: np.ndarray, n_bars: int, n_tracks: int,
                         n_timesteps: int) -> np.ndarray:
    """Validate a structure-conditioning tensor: tile partial bars, fix
    empty bars."""
    s = np.asarray(s, dtype=bool)
    expected = [n_bars, n_tracks, n_timesteps]
    dims = list(s.shape)
    if dims != expected:
        if (len(dims) != 3 or dims[1:] != expected[1:]
                or dims[0] > n_bars):
            raise ValueError(
                f"structure tensor dims {dims} do not match {expected}")
        reps = -(-n_bars // dims[0])
        s = np.tile(s, (reps, 1, 1))[:n_bars]
    empty = ~s.any(axis=(-1, -2))
    if empty.any():
        s = s.copy()
        s[empty, 0, 0] = True
    return s


def load_structure_file(path: str, n_bars: int, n_tracks: int,
                        n_timesteps: int) -> np.ndarray:
    """Load and validate a structure-conditioning JSON file."""
    with open(path) as f:
        return load_structure_array(np.asarray(json.load(f), dtype=bool),
                                    n_bars, n_tracks, n_timesteps)


def synthesize_audio(midi_path: str, soundfont_path: Optional[str]) -> bool:
    """<file>.mid -> <file>.wav: an external fluidsynth with the soundfont
    when both are present, else the built-in numpy synth. Returns whether a
    wav was written."""
    wav_path = os.path.splitext(midi_path)[0] + ".wav"
    fs = shutil.which("fluidsynth")
    if fs is not None and soundfont_path is not None \
            and os.path.exists(soundfont_path):
        subprocess.run([fs, "-ni", soundfont_path, midi_path, "-F", wav_path,
                        "-r", "44100"], check=False, capture_output=True)
        if os.path.exists(wav_path):
            return True
    from .midi.parser import quantize_song, read_midi
    from .midi.synth import song_to_wav

    song, tpq, _ = read_midi(midi_path)
    song = quantize_song(song, tpq, max(tpq, 1))
    song.resolution = max(tpq, 1)
    song_to_wav(song, wav_path)
    return os.path.exists(wav_path)


def save_song(song: Song, out_dir: str, name: str, *, audio: bool = False,
              soundfont_path: Optional[str] = None) -> None:
    """Write <out_dir>/<name>.mid, and its .wav when `audio` is set."""
    from .midi.writer import write_midi

    os.makedirs(out_dir, exist_ok=True)
    midi_path = os.path.join(out_dir, name + ".mid")
    write_midi(midi_path, song)
    if audio:
        synthesize_audio(midi_path, soundfont_path)
