"""The port's GenerationService (on the CPU) against the JAX package's, on one
model: the JAX native model directory of `test_generate_cli`, converted with
`from_jax_variables` and saved as a port model directory. Unconditioned and
structure-conditioned requests, with and without coalescing; MIDI bytes
equal for the same (mask, tokens); and the HTTP front end on port 0."""
import base64
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from polyphemus_tpu.generate import load_model as jax_load_model
from polyphemus_tpu.serve import GenerationService as JaxService
from polyphemus_tpu_torch.config import TrainConfig
from polyphemus_tpu_torch.convert import from_jax_variables, save_checkpoint
from polyphemus_tpu_torch.generate import load_model
from polyphemus_tpu_torch.models import VAE
from polyphemus_tpu_torch.serve import GenerationService, host_z, serve

from .test_generate_cli import save_native_model
from .torch_port_case import (assert_ids_match, assert_masks_match, port_cfg,
                              to_np)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    jax_dir = save_native_model(tmp_path_factory.mktemp("jax_model"))
    _, variables, cfg = jax_load_model(jax_dir)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = VAE(port_cfg(cfg.model))
    model.load_state_dict(from_jax_variables(variables))
    port_dir = str(tmp_path_factory.mktemp("port_model"))
    save_checkpoint(port_dir, model, TrainConfig(model=port_cfg(cfg.model)))
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def services(model_dirs):
    jax_dir, port_dir = model_dirs
    return {
        "jax": JaxService(jax_dir, batch_cap=8, tiers=[1, 8]),
        True: GenerationService(port_dir, batch_cap=8, tiers=[1, 8],
                                device="cpu"),
        False: GenerationService(port_dir, batch_cap=8, tiers=[1, 8],
                                 coalesce=False, device="cpu"),
    }


def check_against_jax(port_dir, got, want, z, structure=None):
    """Masks by the threshold rule, ids by the tie rule on JAX's mask."""
    model, _ = load_model(port_dir, "cpu")
    z = torch.from_numpy(z)
    with torch.no_grad():
        s_logits, _, _ = model.decode(z)
        _, c_logits, _ = model.decode(z, torch.from_numpy(want[0].copy()))
    if structure is None:
        assert_masks_match(got[0], want[0], to_np(s_logits))
    else:
        np.testing.assert_array_equal(got[0], want[0])
    assert got[1].dtype == np.uint8 and got[1].shape == want[1].shape
    assert_ids_match(got[1], want[1], to_np(c_logits), mask=want[0])


@pytest.mark.parametrize("coalesce", [True, False],
                         ids=["coalesce", "no_coalesce"])
def test_service_matches_jax(services, model_dirs, coalesce):
    svc, jsvc = services[coalesce], services["jax"]
    got, want = svc.generate(3, seed=7), jsvc.generate(3, seed=7)
    check_against_jax(model_dirs[1], got, want, host_z(7, 3, svc.mc.d))

    with open(os.path.join(ROOT, "examples", "structure.json")) as f:
        structure = json.load(f)
    got = svc.generate(2, seed=4, structure=structure)
    want = jsvc.generate(2, seed=4, structure=structure)
    check_against_jax(model_dirs[1], got, want, host_z(4, 2, svc.mc.d),
                      structure)


def test_render_midi_bytes_match_jax(services):
    svc, jsvc = services[True], services["jax"]
    mask, tokens = jsvc.generate(2, seed=11)
    for i in range(2):
        ours = svc.render_midi(mask[i], tokens[i])
        assert ours[:4] == b"MThd"
        assert ours == jsvc.render_midi(mask[i], tokens[i])


def test_save_song_matches_jax(services, tmp_path):
    """`song_from_tokens` + `save_song` write the same MIDI file as the JAX
    package's for the same (mask, tokens)."""
    from polyphemus_tpu import generate as jgen
    from polyphemus_tpu_torch import generate as pgen

    mask, tokens = services["jax"].generate(1, seed=12)
    res = services[True].mc.resolution
    pgen.save_song(pgen.song_from_tokens(tokens[0], mask[0], res),
                   str(tmp_path / "port"), "s")
    jgen.save_song(jgen.song_from_tokens(tokens[0], mask[0], res),
                   str(tmp_path / "jax"), "s")
    ours = (tmp_path / "port" / "s.mid").read_bytes()
    assert ours[:4] == b"MThd"
    assert ours == (tmp_path / "jax" / "s.mid").read_bytes()


def test_coalesced_requests_equal_solo_calls(services):
    """Pre-load the queue, wake the dispatcher once: one device call whose
    per-request outputs equal solo calls."""
    from polyphemus_tpu_torch import serve as S

    svc = services[True]
    seeds = (10, 11, 12, 13)
    solo = {seed: svc.generate(1, seed=seed) for seed in seeds}
    works = [S._Work((0.0, 0.0, False), host_z(seed, 1, svc.mc.d), None)
             for seed in seeds]
    calls = svc.stats["device_calls"]
    with svc._pending_cv:
        svc._pending.extend(works)
        svc._pending_cv.notify()
    for w in works:
        assert w.event.wait(120) and w.err is None
    assert svc.stats["device_calls"] == calls + 1
    for w, seed in zip(works, seeds):
        np.testing.assert_array_equal(w.out[0], solo[seed][0])
        np.testing.assert_array_equal(w.out[1], solo[seed][1])


def test_tiers_validated(model_dirs):
    with pytest.raises(ValueError, match="tiers must be >= 1"):
        GenerationService(model_dirs[1], batch_cap=4, tiers=[0, 4],
                          device="cpu")
    with pytest.raises(ValueError, match="largest tier"):
        GenerationService(model_dirs[1], batch_cap=4, tiers=[1, 2],
                          device="cpu")


def _post(url, payload):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_front_end(model_dirs):
    httpd, svc = serve(model_dirs[1], port=0, batch_cap=4, device="cpu")
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            body = json.loads(r.read())
        assert body["status"] == "ok" and body["batch_cap"] == 4
        assert body["device"] == "cpu" and body["tiers"] == [1, 4]

        status, body = _post(url, {"n": 2, "seed": 5})
        assert status == 200 and len(body["midi_b64"]) == 2
        assert base64.b64decode(body["midi_b64"][0])[:4] == b"MThd"
        assert _post(url, {"n": 2, "seed": 5})[1] == body

        s = np.zeros((2, 4, 32), bool)
        s[:, :, ::8] = True
        status, body = _post(url, {"n": 1, "format": "tokens",
                                   "structure": s.tolist()})
        assert status == 200
        np.testing.assert_array_equal(np.asarray(body["mask"], bool)[0], s)
        assert np.asarray(body["tokens"]).shape == (1, 2, 4, 32, 15, 2)

        status, body = _post(url, {"n": 99})
        assert status == 400 and "n must be" in body["error"]
        status, body = _post(url, {"n": 1, "content_temp": -0.5})
        assert status == 400 and "temperatures" in body["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
