"""The port's serving path against the JAX engine, on the CPU: ``TTSEngine``
(phonemes, buckets, phrase splits, synthesize / chunked / streaming / batch,
frame-budget escalation, voice conversion), ``DynamicBatcher``, the HTTP API
and the Gradio app's import guard; a paragraph's pieces as batched calls
against each piece alone, and the reader of ``engine.rows_per_call.long``.

Both engines load ``tests/test_engine.py``'s tiny configuration with
``max_frames=96``, one module-scoped engine each. Weights: the JAX engine's
own init, completed with the modules its ``infer`` init does not create
(posterior encoders, yin decoder: converted from the port's init by
``vits_tpu.utils.convert_torch``), zero-init heads perturbed, the decoder's
weight-norm gains raised so the audio is not a bias-level hum, then loaded
into both (``load_flax_params`` into the port). Noise: the port's
``noise_fn`` hands it the draws the JAX engine makes in its jitted programs,
``PRNGKey(seed)`` split as ``vits_tpu/models/synthesizer.py`` splits it.

Tolerance for audio: atol 1e-4, rtol 1e-4, as the JAX engine's own tests
hold batched against single synthesis (the f32 summation order of XLA
against PyTorch through the whole generator: audio std ~0.2, max |err|
~1e-6 measured).
"""

import base64
import importlib.util
import json
import sys
import threading
from collections import Counter
from pathlib import Path
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
import yaml

import jax

from vits_tpu.serve.engine import TTSEngine as JaxEngine
from vits_tpu.utils.convert_torch import convert_synthesizer

from vits_torch.serve import app, http_api
from vits_torch.serve.batcher import DynamicBatcher
from vits_torch.serve.engine import TTSEngine
from vits_torch.text.symbols import symbols
from vits_torch.utils.convert_jax import load_flax_params

from tests.test_torch_modules import perturb_zeros

TOL = dict(rtol=1e-4, atol=1e-4)
DECODER_GAIN = 24

CFG = {
    "train": {"segment_size": 2048},
    "data": {
        "sampling_rate": 22050, "filter_length": 1024, "hop_length": 256,
        "win_length": 1024, "n_mel_channels": 80, "mel_fmin": 0.0,
        "mel_fmax": None, "add_blank": True, "speakers": ["A", "B"],
        "midi_start": -5, "midi_end": 75, "midis": 80,
        "ying_window": 2048, "ying_hop": 256, "tau_max": 2048,
        "octave_range": 24,
    },
    "model": {
        "inter_channels": 96, "hidden_channels": 48, "filter_channels": 64,
        "n_heads": 2, "n_layers": 1, "kernel_size": 3, "p_dropout": 0.0,
        "resblock": "1", "resblock_kernel_sizes": [3],
        "resblock_dilation_sizes": [[1, 3]],
        "upsample_rates": [8, 8, 2, 2], "upsample_initial_channel": 32,
        "upsample_kernel_sizes": [16, 16, 4, 4], "gin_channels": 16,
        "yin_channels": 80, "yin_start": 15, "yin_scope": 50,
        "yin_shift_range": 15,
    },
}

TEXTS = [
    "[P]ni3#hao3[P]",
    "[ZH]你好，世界。[ZH]",
    "[JA]こんにちは、世界。[JA]",
    "[EN]Hello world, it's 3 PM.[EN]",
    "[ZH]今天[ZH][EN]good morning[EN][JA]ありがとう[JA]",
]
LONG = "[P]" + " ".join(["ni3#hao3%"] * 55) + "[P]"


def jax_noise(seed, shapes):
    """The draws of the JAX engine's programs for PRNGKey(seed)."""
    key = jax.random.PRNGKey(seed)
    if "eps_spec" in shapes:  # voice_conversion: r_spec, r_yin
        names = ("eps_spec", "eps_yin")
    else:  # infer_pre_decoder: r_dur (SDP reverse), r_noise (prior)
        names = ("sdp_noise", "eps")
    return {n: np.asarray(jax.random.normal(k, shapes[n]))
            for n, k in zip(names, jax.random.split(key, 2))}


def _merge(full, own):
    """``full`` with every leaf ``own`` has replaced by ``own``'s."""
    if not isinstance(full, dict):
        return np.asarray(own)
    return {k: _merge(v, own[k]) if k in own else v for k, v in full.items()}


def _scale_gains(tree):
    """Every weight-norm gain ``g`` in the tree times DECODER_GAIN."""
    return {k: _scale_gains(v) if isinstance(v, dict)
            else v * np.float32(DECODER_GAIN) if k == "g" else v for k, v in tree.items()}


def _set_params(jeng, engines, params):
    jeng.params = jax.device_put(params)
    for e in engines:
        load_flax_params(e.model, params)


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("serve") / "config.yaml"
    p.write_text(yaml.safe_dump(CFG))
    return str(p)


@pytest.fixture(scope="module")
def engines(cfg_path):
    """(JAX engine, port engine with the JAX noise, port engine with its own
    generator noise, the shared params)."""
    jeng = JaxEngine(cfg_path, checkpoint_path=None, max_frames=96)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        port = TTSEngine(cfg_path, max_frames=96, device="cpu", noise_fn=jax_noise)
        own = TTSEngine(cfg_path, max_frames=96, device="cpu")
    full = convert_synthesizer(port.model.state_dict(), n_layers_text=1, n_kernels=1,
                               resblock_convs=2)["params"]
    params = perturb_zeros({"params": _merge(full, jeng.params["params"])}, seed=1)
    # the decoder's init (normal, std 0.01) makes a near-constant hum of
    # ~1e-3; gains x24 give audio with signal (std ~0.2, peak ~0.8)
    params["params"]["waveform_decoder"] = _scale_gains(params["params"]["waveform_decoder"])
    _set_params(jeng, (port, own), params)
    return jeng, port, own, params


@pytest.mark.parametrize("text", TEXTS + [LONG])
def test_get_phoneme_exact(engines, text):
    jeng, port, _, _ = engines
    ref, out = jeng.get_phoneme(text), port.get_phoneme(text)
    assert out[2] == ref[2]
    for o, r in zip(out[:2], ref[:2]):
        assert o.dtype == r.dtype
        np.testing.assert_array_equal(o, r)


def test_buckets_exact(engines):
    jeng, port, _, _ = engines
    assert port.TEXT_BUCKETS == jeng.TEXT_BUCKETS
    assert port.FRAME_BUCKETS == jeng.FRAME_BUCKETS
    assert port.BATCH_BUCKETS == jeng.BATCH_BUCKETS
    assert port.VC_BUCKETS == jeng.VC_BUCKETS and port.VC_OVERLAP == jeng.VC_OVERLAP
    assert [port._bucket(n) for n in range(1, 500)] == [jeng._bucket(n) for n in range(1, 500)]
    for max_frames in (96, 256, 700, 1000, 2000, 3000):
        jeng.max_frames = port.max_frames = max_frames
        try:
            assert port._frame_buckets() == jeng._frame_buckets()
        finally:
            jeng.max_frames = port.max_frames = 96


@pytest.mark.parametrize("limit", [16, 40, 384])
def test_split_segments_exact(engines, limit):
    jeng, port, _, _ = engines
    comma, space, a = symbols.index(","), symbols.index(" "), symbols.index("a")
    seqs = [
        [a] * 10 + [comma] + [a] * 10 + [space] + [a] * 10,
        [a] * 100,
        list(jeng.get_phoneme(LONG)[0]),
        ([a] * 7 + [space]) * 20,
    ]
    for seq in seqs:
        seq, lang = np.asarray(seq), np.arange(len(seq)) % 4
        ref = jeng._split_segments(seq, lang, limit)
        out = port._split_segments(seq, lang, limit)
        assert len(out) == len(ref)
        for (s, la), (rs, rla) in zip(out, ref):
            np.testing.assert_array_equal(s, rs)
            np.testing.assert_array_equal(la, rla)


@pytest.mark.parametrize("i,speaker,seed,shift,duration", [
    (0, 0, 1, 0, 1.0), (1, 1, 2, 5, 1.0), (2, 0, 3, -11, 1.2), (3, 1, 4, 0, 0.8),
    (4, 0, 5, 3, 1.0),
])
def test_synthesize_matches_jax(engines, i, speaker, seed, shift, duration):
    jeng, port, _, _ = engines
    ref = jeng.synthesize(TEXTS[i], speaker, seed, shift, duration)
    out = port.synthesize(TEXTS[i], speaker, seed, shift, duration)
    assert out[0] == ref[0] and out[1][0] == ref[1][0] == 22050
    assert out[1][1].shape == ref[1][1].shape and out[1][1].dtype == np.float32
    np.testing.assert_allclose(out[1][1], ref[1][1], **TOL)


def test_long_input_split_matches_jax(engines):
    """~1000 ids after add_blank: split at phrase boundaries into pieces that
    fit the 384 bucket, piece i seeded seed + i, concatenated."""
    jeng, port, _, _ = engines
    assert len(port.get_phoneme(LONG)[0]) > 900
    _, (_, ref) = jeng.synthesize(LONG, 1, seed=3)
    _, (_, out) = port.synthesize(LONG, 1, seed=3)
    assert len(out) == len(ref) > port.max_frames * port.hop
    np.testing.assert_allclose(out, ref, **TOL)


def _longer(params):
    """``params`` with the durations pushed up (the SDP's output affine
    shifted), so that ``SATURATING`` at duration 0.25 saturates a first frame
    bucket of 32."""
    dp = params["params"]["duration_predictor"]["flow_pre"]
    longer = jax.tree_util.tree_map(lambda a: a, params)
    longer["params"]["duration_predictor"] = dict(
        params["params"]["duration_predictor"],
        flow_pre={"m": dp["m"] - np.array([2.0, 0.0], np.float32), "logs": dp["logs"]},
    )
    return longer


SATURATING = "[P]ni3#hao3[P]"


def test_frame_budget_escalation_matches_jax(engines):
    """Durations pushed up so the first frame bucket saturates: both engines
    escalate to the same budget, in the single and in the batched path."""
    jeng, port, _, params = engines
    text = SATURATING
    saved = jeng.FRAME_BUCKETS
    try:
        _set_params(jeng, (port,), _longer(params))
        jeng.FRAME_BUCKETS = port.FRAME_BUCKETS = (32, 64)
        n = len(port.get_phoneme(text)[0])
        assert port._first_frames(n, 0.25) == 32  # want = n * 6 * 0.25
        _, (_, ref) = jeng.synthesize(text, 0, seed=2, duration=0.25)
        _, (_, out) = port.synthesize(text, 0, seed=2, duration=0.25)
        assert len(out) == len(ref) > 32 * port.hop, len(out) // port.hop
        np.testing.assert_allclose(out, ref, **TOL)
        reqs = [{"text": text, "seed": 2, "duration": 0.25}, {"text": "[P]a1[P]", "seed": 4}]
        ref_b, out_b = jeng.synthesize_batch(reqs), port.synthesize_batch(reqs)
        for o, r in zip(out_b, ref_b):
            np.testing.assert_allclose(o, r, **TOL)
        np.testing.assert_array_equal(out_b[0], out)
    finally:
        jeng.FRAME_BUCKETS = port.FRAME_BUCKETS = saved
        _set_params(jeng, (port,), params)


def test_synthesize_chunked_matches_jax(engines):
    jeng, port, _, _ = engines
    text = "[P]ni3#hao3 ni3#hao3[P]"
    _, (_, ref) = jeng.synthesize_chunked(text, 1, seed=2, chunk_frames=16, overlap_frames=16)
    _, (_, out) = port.synthesize_chunked(text, 1, seed=2, chunk_frames=16, overlap_frames=16)
    assert len(out) == len(ref) > 0
    np.testing.assert_allclose(out, ref, **TOL)


def test_streaming_equals_chunked_bitwise(engines):
    _, port, own, _ = engines
    text = "[P]ni3#hao3 ni3#hao3[P]"
    for eng in (port, own):
        _, (_, full) = eng.synthesize_chunked(text, 1, seed=5, chunk_frames=16,
                                              overlap_frames=16)
        phones, stream = eng.synthesize_streaming(text, 1, seed=5, chunk_frames=16,
                                                  overlap_frames=16)
        chunks = list(stream)
        assert phones == eng.get_phoneme(text)[2]
        assert len(chunks) >= 2  # actually incremental
        assert all(len(c) <= 16 * eng.hop for c in chunks)
        np.testing.assert_array_equal(np.concatenate(chunks), full)


BATCH = [
    {"text": "[P]ni3#hao3[P]", "speaker_id": 0, "seed": 7},
    {"text": "[P]shi4 jie4[P]", "speaker_id": 1, "seed": 9, "scope_shift": -4},
    {"text": "[P]ni3#hao3%shi4[P]", "speaker_id": 1, "seed": 11, "duration": 1.3},
    {"text": "[EN]one two three four five six seven[EN]", "seed": 2, "scope_shift": 6},
]


def test_synthesize_batch_matches_jax(engines):
    jeng, port, _, _ = engines
    ref, out = jeng.synthesize_batch(BATCH), port.synthesize_batch(BATCH)
    assert len(out) == len(BATCH)
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == np.float32 and len(o) > 0
        np.testing.assert_allclose(o, r, **TOL)


def test_batch_rows_equal_single_requests(engines):
    """Each row of a batch is what the request gives alone (synthesize),
    for the JAX noise and for the port's own generator noise."""
    _, port, own, _ = engines
    for eng in (port, own):
        together = eng.synthesize_batch(BATCH)
        for req, a in zip(BATCH, together):
            np.testing.assert_allclose(a, eng.synthesize(**req)[1][1], rtol=1e-5, atol=1e-5)


def test_batch_composition_independent(engines):
    """The port's default noise: a request's audio does not depend on what
    it was batched with, and distinct seeds give distinct audio."""
    _, _, own, _ = engines
    solo = own.synthesize_batch([BATCH[0]])[0]
    together = own.synthesize_batch(BATCH)
    shuffled = own.synthesize_batch([BATCH[2], BATCH[0], BATCH[1]])
    np.testing.assert_allclose(together[0], solo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(shuffled[1], solo, rtol=1e-5, atol=1e-5)
    again = own.synthesize_batch([dict(BATCH[0], seed=8)])[0]
    assert len(again) != len(solo) or not np.array_equal(again, solo)


def test_default_noise_is_reproducible(engines):
    _, _, own, _ = engines
    a = own.synthesize("[P]ni3#hao3[P]", 0, seed=3)[1][1]
    b = own.synthesize("[P]ni3#hao3[P]", 0, seed=3)[1][1]
    c = own.synthesize("[P]ni3#hao3[P]", 0, seed=4)[1][1]
    np.testing.assert_array_equal(a, b)
    assert len(a) != len(c) or not np.array_equal(a, c)


def test_batch_bad_request_isolated(engines):
    _, port, _, _ = engines
    reqs = [
        {"text": "[P]ni3#hao3[P]", "seed": 1},
        {"text": "no language tags here", "seed": 2},
        {"text": "[P]shi4 jie4[P]", "seed": 3},
    ]
    outs = port.synthesize_batch(reqs)
    assert isinstance(outs[1], ValueError)
    assert len(outs[0]) > 0 and len(outs[2]) > 0
    with pytest.raises(ValueError, match="empty phoneme sequence"):
        port.synthesize("untagged text only", 0)


def test_dynamic_batcher_end_to_end(engines):
    _, port, _, _ = engines
    b = DynamicBatcher(port, max_batch=4, max_wait_ms=30.0)
    try:
        futs = [b.submit("[P]ni3#hao3[P]", speaker_id=i % 2, seed=i) for i in range(5)]
        bad = b.submit("no tags", seed=1)
        outs = [f.result(timeout=300) for f in futs]
        for (sr, audio), i in zip(outs, range(5)):
            assert sr == port.sampling_rate
            assert len(audio) > 0 and np.isfinite(audio).all()
            ref = port.synthesize("[P]ni3#hao3[P]", i % 2, seed=i)[1][1]
            np.testing.assert_allclose(audio, ref, rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError):
            bad.result(timeout=300)
    finally:
        b.close()
    assert not b._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("[P]ni3[P]")


def test_dynamic_batcher_threads(engines):
    """Requests submitted from more threads than cores, with a short switch
    interval, all resolve, each to its own audio: no request is lost."""
    _, _, own, _ = engines
    b = DynamicBatcher(own, max_batch=8, max_wait_ms=20.0)
    n = 16
    futs = [None] * n
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def go(i):
            futs[i] = b.submit("[P]shi4 jie4[P]", speaker_id=i % 2, seed=100 + i)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        outs = [f.result(timeout=300)[1] for f in futs]
    finally:
        sys.setswitchinterval(interval)
        b.close()
    for i, audio in enumerate(outs):
        ref = own.synthesize("[P]shi4 jie4[P]", i % 2, seed=100 + i)[1][1]
        np.testing.assert_allclose(audio, ref, rtol=1e-5, atol=1e-5)


def _waveform(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050
    f0 = 110 + 40 * np.sin(2 * np.pi * 0.7 * t)
    wav = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 22050) + 0.01 * rng.standard_normal(n)
    return wav.astype(np.float32)


@pytest.fixture
def small_vc(engines):
    """Both engines with one 8192-sample VC bucket and 2048 samples of
    overlap, so a 20000-sample input runs three cross-faded windows."""
    jeng, port, _, _ = engines
    for e in (jeng, port):
        e.VC_BUCKETS, e.VC_OVERLAP = (8192,), 2048
    yield jeng, port
    for e in (jeng, port):
        del e.VC_BUCKETS, e.VC_OVERLAP


@pytest.mark.parametrize("n", [5000, 20000])
def test_voice_conversion_matches_jax(small_vc, n):
    jeng, port = small_vc
    wav = _waveform(n, n)
    ref = jeng.voice_conversion(wav, 0, 1, seed=3)
    out = port.voice_conversion(wav, 0, 1, seed=3)
    assert out.shape == ref.shape and out.dtype == np.float32
    assert len(out) == (n if n > 8192 else n // 256 * 256)
    np.testing.assert_allclose(out, ref, **TOL)


def _server(engine):
    srv = ThreadingHTTPServer(("localhost", 0), http_api.make_handler(engine))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def _post(port, body: bytes):
    req = urllib.request.Request(f"http://localhost:{port}/synthesize", data=body,
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_http_round_trip(engines):
    _, port_eng, _, _ = engines
    srv, port = _server(port_eng)
    try:
        with urllib.request.urlopen(f"http://localhost:{port}/health", timeout=60) as r:
            assert json.loads(r.read()) == {"status": "ok", "sampling_rate": 22050}
        ipa, (sr, ref) = port_eng.synthesize("[P]ni3#hao3[P]", 1, seed=4)
        body = json.dumps({"text": "[P]ni3#hao3[P]", "speaker_id": 1, "seed": 4}).encode()
        with _post(port, body) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            wav = r.read()
        assert wav == http_api.wav_bytes(sr, ref)
        body = json.dumps({"text": "[P]ni3#hao3[P]", "speaker_id": 1, "seed": 4,
                           "format": "json"}).encode()
        with _post(port, body) as r:
            out = json.loads(r.read())
        assert out["ipa"] == ipa and out["sampling_rate"] == sr
        assert out["num_samples"] == len(ref)
        assert base64.b64decode(out["wav_base64"]) == wav
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_error_paths(engines):
    _, port_eng, _, _ = engines
    srv, port = _server(port_eng)
    try:
        for body, code in ((b"not json", 400), (b'{"seed": 1}', 400),
                           (json.dumps({"text": "untagged"}).encode(), 500)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, body)
            assert e.value.code == code
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://localhost:{port}/nope", timeout=60)
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()


def test_wav_bytes_header():
    wav = http_api.wav_bytes(22050, np.zeros(100, np.float32))
    assert wav[:4] == b"RIFF" and wav[8:12] == b"WAVE"
    assert int.from_bytes(wav[24:28], "little") == 22050
    assert len(wav) == 44 + 200


def test_app_needs_gradio(engines, monkeypatch):
    _, port, _, _ = engines
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio is not installed"):
        app.build_interface(port)


def test_command_lines_parse():
    a = app.parse_args(["-c", "c.yaml", "--port", "9000", "--device", "cpu"])
    assert (a.config, a.checkpoint, a.port, a.device) == ("c.yaml", None, 9000, "cpu")
    h = http_api.parse_args(["-c", "c.yaml", "-p", "g.pt", "--bf16"])
    assert (h.config, h.checkpoint, h.port, h.bf16, h.device) == ("c.yaml", "g.pt", 8080, True, None)


def test_engine_needs_a_card_by_default(cfg_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTSEngine(cfg_path)


def test_engine_loads_a_saved_state_dict(engines, cfg_path, tmp_path):
    _, _, own, _ = engines
    path = tmp_path / "generator.pt"
    torch.save(own.model.state_dict(), path)
    with torch.random.fork_rng():
        torch.manual_seed(123)
        loaded = TTSEngine(cfg_path, checkpoint_path=str(path), max_frames=96, device="cpu")
    a = own.synthesize("[P]ni3#hao3[P]", 1, seed=6)[1][1]
    b = loaded.synthesize("[P]ni3#hao3[P]", 1, seed=6)[1][1]
    np.testing.assert_array_equal(a, b)
    assert not loaded.model.training


@pytest.mark.parametrize("shift", [-15, 0, 15])
@pytest.mark.parametrize("duration", [0.8, 1.0, 1.3])
def test_segment_controls_as_tensors_equal_scalars(engines, shift, duration):
    """``synthesize`` of a one-piece text hands ``model.infer`` the duration
    and the scope shift as [1] tensors on the engine's device (a batch row's
    form, which a CUDA graph takes as inputs); each call gives, bit for bit,
    what the same call with the scalar forms gives, and the text's audio is
    the scalar call's."""
    _, _, own, _ = engines
    model = own.model
    original = model.infer
    calls = []

    def infer(*args, **kwargs):
        out = original(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    model.infer = infer
    try:
        _, (_, audio) = own.synthesize(TEXTS[3], 1, seed=7, scope_shift=shift,
                                       duration=duration)
    finally:
        del model.infer
    assert calls
    with torch.inference_mode():
        for args, kwargs, (wav, _, y_len) in calls:
            for v in (kwargs["length_scale"], kwargs["scope_shift"]):
                assert isinstance(v, torch.Tensor) and v.shape == (1,) and v.device == own.device
            wav_s, _, y_len_s = original(*args, **dict(kwargs, length_scale=duration,
                                                       scope_shift=shift))
            assert torch.equal(y_len, y_len_s)
            assert torch.equal(wav, wav_s)
    np.testing.assert_array_equal(audio, wav_s[0, : int(y_len_s[0]) * own.hop, 0].numpy())


@pytest.mark.parametrize("case", ["split", "escalating"])
def test_wrapped_infer_sees_every_budgeted_call(engines, case, monkeypatch):
    """``engine.model.infer`` wrapped as the benchmark wraps it sees exactly
    the calls the counter ``serve.infer_calls`` counts, for a paragraph
    split into pieces and for a piece whose frame budget escalates; on the
    CPU no call is graphed (the graph counters stay 0, the model has no
    cache)."""
    from perfbench import tracing
    from vits_torch.utils import profiling

    _, _, own, _ = engines
    if case == "escalating":
        monkeypatch.setattr(own, "FRAME_BUCKETS", (4, 8))
        monkeypatch.setattr(own, "_first_frames", lambda n, duration: 4)
    spans = tracing.Spans()
    undo = tracing.wrap(own.model, "infer", "infer", spans)
    profiling.reset()
    was = profiling.set_tracing(True)
    try:
        own.synthesize(LONG if case == "split" else TEXTS[0], 0, seed=5)
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.set_tracing(was)
        profiling.reset()
        undo()
    assert spans.count("infer") == counters["serve.infer_calls"]
    if case == "split":
        pieces = own._split_segments(*own.get_phoneme(LONG)[:2], own.TEXT_BUCKETS[-1])
        keys = Counter((own._bucket(len(s)), own._first_frames(len(s), 1.0)) for s, _ in pieces)
        assert counters["serve.infer_calls"] == sum(map(_bucketed_calls, keys.values()))
        assert counters["serve.rows"] == len(pieces) > counters["serve.infer_calls"]
        assert "serve.escalations" not in counters
    else:
        assert counters["serve.escalations"] == 2 and counters["serve.infer_calls"] == 3
    assert counters.get("serve.graph_captures", 0) == counters.get("serve.graph_replays", 0) == 0
    assert own.model.infer_graphs is None


def _bucketed_calls(n: int) -> int:
    """The calls of a group of ``n`` rows cut into batch buckets of 8, 4, 2
    and 1, largest first."""
    return n // 8 + bin(n % 8).count("1")


@pytest.fixture
def counted():
    """The port's counters on for the test: ``counted()`` reads what they
    counted since ``counted.reset()``."""
    from vits_torch.utils import profiling

    def read():
        return dict(profiling.snapshot()["counters"])

    read.reset = profiling.reset
    profiling.reset()
    was = profiling.set_tracing(True)
    yield read
    profiling.set_tracing(was)
    profiling.reset()


def _rows_seen(model, monkeypatch) -> list[int]:
    """The rows of each ``model.infer`` call from here on."""
    rows, original = [], model.infer

    def infer(x, *args, **kwargs):
        rows.append(x.shape[0])
        return original(x, *args, **kwargs)

    monkeypatch.setattr(model, "infer", infer)
    return rows


def _pieces(engine, text):
    seq, lang, _ = engine.get_phoneme(text)
    return engine._split_segments(seq, lang, engine.TEXT_BUCKETS[-1])


def _alone(engine, text, speaker, seed) -> list[np.ndarray]:
    """``text``'s pieces alone, each the engine's budget loop on one row
    (piece i seeded seed + i): the audio of each."""
    rows = engine._rows(*engine.get_phoneme(text)[:2], speaker, seed, 0, 1.0)
    return [engine._budget_walk([row], fill=False)[0].numpy() for row in rows]


def _segments(engine, text, speaker, seed):
    """``text``'s pieces alone (``_alone``), concatenated."""
    return np.concatenate(_alone(engine, text, speaker, seed))


@pytest.mark.parametrize("which", ["jax_noise", "own_noise"])
def test_long_input_batched_equals_pieces_alone(engines, which, counted, monkeypatch):
    """A paragraph's pieces run as batched calls (LONG: 4 pieces at one key,
    one call of 4 rows) give the audio of each piece alone at batch 1,
    concatenated: lengths exact, audio within TOL."""
    _, port, own, _ = engines
    eng = port if which == "jax_noise" else own
    want = _segments(eng, LONG, 1, 3)
    rows = _rows_seen(eng.model, monkeypatch)
    counted.reset()
    _, (_, got) = eng.synthesize(LONG, 1, seed=3)
    assert rows == [4] and counted()["serve.rows"] == 4
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("text", TEXTS)
def test_one_piece_is_one_call_at_one_row(engines, text, counted, monkeypatch):
    """A text of one piece makes one call at one row, and its audio is the
    JAX engine's within TOL."""
    jeng, port, _, _ = engines
    want = jeng.synthesize(text, 1, 7)[1][1]
    rows = _rows_seen(port.model, monkeypatch)
    counted.reset()
    _, (_, got) = port.synthesize(text, 1, seed=7)
    assert rows == [1]
    assert counted()["serve.infer_calls"] == counted()["serve.rows"] == 1
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("repeats,calls", [(3, [2, 1]), (5, [4, 1]), (7, [4, 2, 1]),
                                           (9, [8, 1])])
def test_group_cut_into_buckets_without_empty_rows(engines, repeats, calls, counted,
                                                    monkeypatch):
    """Pieces at one (text bucket, frame budget) run in batch buckets taken
    largest first, no call padded with an empty row: 5 pieces are calls of 4
    and 1, not 8 with 3 zero rows. Text buckets of 16 and 32 ids cut the
    paragraph into pieces of 26-27 ids, one a repeat."""
    _, _, own, _ = engines
    monkeypatch.setattr(own, "TEXT_BUCKETS", (16, 32))
    text = "[P]" + " ".join(["ni3#hao3%"] * repeats) + "[P]"
    pieces = _pieces(own, text)
    assert len(pieces) == repeats
    assert {(own._bucket(len(s)), own._first_frames(len(s), 1.0)) for s, _ in pieces} == {(32, 96)}
    rows = _rows_seen(own.model, monkeypatch)
    _, (_, audio) = own.synthesize(text, 0, seed=2)
    got = counted()
    assert rows == calls
    assert got["serve.infer_calls"] == len(calls) == _bucketed_calls(repeats)
    assert got["serve.rows"] == repeats
    assert got["serve.frames_decoded"] == 96 * repeats  # no empty row decoded
    assert got["serve.frames_kept"] * own.hop == len(audio)


@pytest.mark.parametrize("which", ["jax_noise", "own_noise"])
def test_saturated_row_alone_is_redone(engines, which, counted, monkeypatch):
    """Every piece starts at a frame budget that only the longest piece's
    predicted length reaches: that row alone is made again from the next
    bucket (one escalation, one more call at one row); the audio is each
    piece's alone at the same budgets, concatenated."""
    _, port, own, _ = engines
    eng = port if which == "jax_noise" else own
    monkeypatch.setattr(eng, "TEXT_BUCKETS", (16, 32))
    text = "[P]" + " ".join(["ni3#hao3%"] * 4) + "[P]"
    lengths = [len(a) // eng.hop for a in _alone(eng, text, 0, 5)]
    budget = max(lengths)
    assert sorted(lengths)[-2] < budget < eng.max_frames, lengths
    monkeypatch.setattr(eng, "FRAME_BUCKETS", (budget,))
    monkeypatch.setattr(eng, "_first_frames", lambda n, duration: budget)
    want = _segments(eng, text, 0, 5)
    rows = _rows_seen(eng.model, monkeypatch)
    counted.reset()
    _, (_, got) = eng.synthesize(text, 0, seed=5)
    after = counted()
    assert rows == [4, 1]
    assert after["serve.escalations"] == 1
    assert after["serve.infer_calls"] == 2 and after["serve.rows"] == 5
    assert after["serve.frames_decoded"] == budget * 4 + eng.max_frames
    assert after["serve.frames_kept"] == sum(lengths)
    assert len(got) == len(want) == sum(lengths) * eng.hop
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("which", ["jax_noise", "own_noise"])
def test_saturated_rows_are_redone_together(engines, which, counted, monkeypatch):
    """Every piece starts at a frame budget that the two longest pieces'
    predicted lengths reach: both are made again from the next bucket in one
    call of 2 rows (two escalations, one more call and one more host sync);
    the audio is each piece's alone at the same budgets, concatenated."""
    from vits_torch.utils import profiling

    _, port, own, _ = engines
    eng = port if which == "jax_noise" else own
    monkeypatch.setattr(eng, "TEXT_BUCKETS", (16, 32))
    text = "[P]" + " ".join(["ni3#hao3%"] * 4) + "[P]"
    lengths = [len(a) // eng.hop for a in _alone(eng, text, 0, 5)]
    budget = sorted(lengths)[-2]
    assert sorted(lengths)[-3] < budget < eng.max_frames, lengths
    monkeypatch.setattr(eng, "FRAME_BUCKETS", (budget,))
    monkeypatch.setattr(eng, "_first_frames", lambda n, duration: budget)
    want = _segments(eng, text, 0, 5)
    rows = _rows_seen(eng.model, monkeypatch)
    counted.reset()
    _, (_, got) = eng.synthesize(text, 0, seed=5)
    after = counted()
    assert rows == [4, 2]
    assert after["serve.escalations"] == 2
    assert after["serve.infer_calls"] == 2 and after["serve.rows"] == 6
    assert after["serve.frames_decoded"] == budget * 4 + eng.max_frames * 2
    assert profiling.snapshot()["spans"]["vits.serve.sync"]["count"] == 2
    assert len(got) == len(want) == sum(lengths) * eng.hop
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture
def saturating(engines):
    """The port's two engines with ``_longer`` weights and frame buckets of
    32 and 64 (and ``max_frames`` 96) for the test."""
    _, port, own, params = engines
    for e in (port, own):
        load_flax_params(e.model, _longer(params))
        e.FRAME_BUCKETS = (32, 64)
    yield port, own
    for e in (port, own):
        del e.FRAME_BUCKETS
        load_flax_params(e.model, params)


@pytest.mark.parametrize("which", ["jax_noise", "own_noise"])
def test_saturated_batch_request_is_not_repeated(saturating, which, counted, monkeypatch):
    """A batch's request whose first budget saturates is phonemized once, and
    its row is made again from the next budget only: its calls are at 32 and
    64 frames, and the saturated call at 32 is not repeated. Its audio is
    ``synthesize``'s bit for bit: both redo the row alone at the same key."""
    port, own = saturating
    eng = port if which == "jax_noise" else own
    reqs = [{"text": SATURATING, "seed": 2, "duration": 0.25}, {"text": "[P]a1[P]", "seed": 4}]
    _, (_, alone) = eng.synthesize(SATURATING, 0, seed=2, duration=0.25)
    n = len(eng.get_phoneme(SATURATING)[0])
    texts, budgets = Counter(), []
    get_phoneme, infer = eng.get_phoneme, eng.model.infer

    def g2p(text):
        texts[text] += 1
        return get_phoneme(text)

    def spy(x, t, x_lengths, *args, **kwargs):
        if n in x_lengths.tolist():
            budgets.append(kwargs["max_frames"])
        return infer(x, t, x_lengths, *args, **kwargs)

    monkeypatch.setattr(eng, "get_phoneme", g2p)
    monkeypatch.setattr(eng.model, "infer", spy)
    counted.reset()
    out = eng.synthesize_batch(reqs)
    assert texts == Counter(r["text"] for r in reqs)
    assert budgets == [32, 64]
    assert counted()["serve.escalations"] == 1 and counted()["serve.requests"] == 2
    np.testing.assert_array_equal(out[0], alone)


SHORT_AT_LONG_KEY = "[P]" + " ".join(["ni3#hao3%"] * 12) + "[P]"


@pytest.mark.parametrize("which", ["jax_noise", "own_noise"])
def test_long_request_shares_the_batch_call(engines, which, counted, monkeypatch):
    """A batch of LONG (4 pieces over the largest text bucket) and a short
    request at the pieces' (text bucket, first budget) is one call of 5 rows
    padded to 8 and one host sync: the over-long request's pieces are rows of
    the batch. Each audio is within TOL of the request alone."""
    from vits_torch.utils import profiling

    _, port, own, _ = engines
    eng = port if which == "jax_noise" else own
    pieces = _pieces(eng, LONG) + _pieces(eng, SHORT_AT_LONG_KEY)
    assert len(pieces) == 5
    assert len({(eng._bucket(len(s)), eng._first_frames(len(s), 1.0)) for s, _ in pieces}) == 1
    reqs = [{"text": LONG, "speaker_id": 1, "seed": 3},
            {"text": SHORT_AT_LONG_KEY, "speaker_id": 0, "seed": 8}]
    alone = [eng.synthesize(**r)[1][1] for r in reqs]
    rows = _rows_seen(eng.model, monkeypatch)
    counted.reset()
    out = eng.synthesize_batch(reqs)
    assert rows == [8]
    assert counted()["serve.infer_calls"] == 1 and counted()["serve.rows"] == 5
    assert profiling.snapshot()["spans"]["vits.serve.sync"]["count"] == 1
    for o, a in zip(out, alone):
        assert len(o) == len(a) > 0
        np.testing.assert_allclose(o, a, **TOL)


@pytest.mark.parametrize("which", ["jax_noise", "own_noise"])
def test_batch_group_over_the_largest_bucket_is_cut(engines, which, counted, monkeypatch):
    """A batch of 11 requests at one (text bucket, first budget) runs as a
    full call of 8 rows and a call of 3 rows padded to 4: no call has more
    rows than the largest batch bucket. Each audio is within TOL of the
    request alone."""
    _, port, own, _ = engines
    eng = port if which == "jax_noise" else own
    reqs = [{"text": TEXTS[0], "speaker_id": i % 2, "seed": i} for i in range(11)]
    alone = [eng.synthesize(**r)[1][1] for r in reqs]
    rows = _rows_seen(eng.model, monkeypatch)
    counted.reset()
    out = eng.synthesize_batch(reqs)
    budget = eng._first_frames(len(eng.get_phoneme(TEXTS[0])[0]), 1.0)
    assert rows == [8, 4]
    assert counted()["serve.infer_calls"] == 2 and counted()["serve.rows"] == 11
    assert counted()["serve.frames_decoded"] == budget * 12
    for o, a in zip(out, alone):
        assert len(o) == len(a) > 0
        np.testing.assert_allclose(o, a, **TOL)


def _rows_reader():
    path = Path(__file__).resolve().parent.parent / "perfbench" / "metrics" / \
        "engine.rows_per_call.long.py"
    spec = importlib.util.spec_from_file_location("rows_per_call_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("counters,want", [
    ({"serve.infer_calls": 4, "serve.rows": 9}, 2.25),
    ({"serve.infer_calls": 5, "serve.rows": 5}, 1.0),
    ({"serve.infer_calls": 5, "serve.frames_decoded": 5000}, None),  # no rows counted
    ({"serve.rows": 3}, None),
    ({}, None),
])
def test_rows_per_call_reads_the_counters(counters, want, monkeypatch):
    from vits_torch.utils import profiling

    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {}, "counters": counters})
    assert _rows_reader().read({}) == want


def test_rows_per_call_reads_nothing_without_the_aggregate(monkeypatch):
    from vits_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    assert _rows_reader().read({}) is None


def test_rows_per_call_reads_a_traced_paragraph(engines, counted):
    """Over a paragraph synthesized with the counters on, the reader gives
    the engine's rows over its calls (LONG: 4 rows in one call)."""
    _, _, own, _ = engines
    own.synthesize(LONG, 0, seed=9)
    assert _rows_reader().read({}) == 4.0
