"""The port's WAV decoder (mme_tpu_torch/data/wavio.py and its own
native/wavio.cpp) against mme_tpu/data/wavio.py, on files the test writes:
8, 16, 44.1 and 48 kHz, mono and stereo, PCM 16, 24 and 32-bit and IEEE
float32.

Tolerances: the port's library against JAX's decoder source built with the
same compiler and flags, bit for bit (one algorithm, one host); every
path against the numpy path (the written samples' channel mean through
``resample_numpy``) and against JAX's stdlib path within 1e-5 on waves in
[-1, 1] (``-ffast-math`` reorders the sums).
"""

import os
import shutil
import struct
import subprocess
import threading
import wave

import numpy as np
import pytest

from mme_tpu.data import wavio as j_wavio

from mme_tpu_torch.data import wavio
from mme_tpu_torch.ops.resample import resample_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, rate, channels, format): PCM bits, or "f32" for IEEE float
FILES = [("m8k16", 8000, 1, 16), ("s16k16", 16000, 2, 16),
         ("m44k16", 44100, 1, 16), ("s48k16", 48000, 2, 16),
         ("m44k24", 44100, 1, 24), ("s48k24", 48000, 2, 24),
         ("s16k32", 16000, 2, 32), ("m48k32", 48000, 1, 32),
         ("m48kf", 48000, 1, "f32"), ("s44kf", 44100, 2, "f32")]


def write_wav(path, samples, rate, fmt):
    """samples [frames, channels] in [-1, 1] → a RIFF/WAVE file; returns
    the samples as the file holds them (quantised), as float32."""
    ch = samples.shape[1]
    if fmt == "f32":
        data = samples.astype("<f4").tobytes()
        held, code, bits = samples.astype(np.float32), 3, 32
    else:
        bits, code = fmt, 1
        scale = 2.0 ** (bits - 1)
        q = np.clip(np.round(samples * scale), -scale, scale - 1).astype(
            np.int64)
        held = (q / scale).astype(np.float32)
        if bits == 24:
            b = (q & 0xFFFFFF).astype("<u4").view(np.uint8).reshape(-1, 4)
            data = b[:, :3].tobytes()
        else:
            data = q.astype(f"<i{bits // 8}").tobytes()
    block = ch * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", code, ch, rate, rate * block, block,
                            bits)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + 16 + 8 + len(data))
                + b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt_chunk
                + b"data" + struct.pack("<I", len(data)) + data)
    return held


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """(path, numpy-path wave at 16 kHz, rate, format) per file."""
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.RandomState(0)
    out = []
    for i, (name, rate, ch, fmt) in enumerate(FILES):
        n = int(rate * (0.25 + 0.05 * i))
        t = np.arange(n) / rate
        x = 0.6 * np.sin(2 * np.pi * (220 + 40 * i) * t)[:, None] \
            + 0.3 * rng.uniform(-1, 1, (n, ch))
        held = write_wav(str(d / f"{name}.wav"), np.clip(x, -1, 1), rate, fmt)
        out.append((str(d / f"{name}.wav"),
                    resample_numpy(held.mean(axis=1), rate, 16000), rate,
                    fmt))
    return out


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """JAX's decoder source (native/wavio.cpp) built with the port's
    compiler flags into a directory of the test's own."""
    out = str(tmp_path_factory.mktemp("jax_lib") / "libwavio.so")
    subprocess.run([shutil.which("g++"), *wavio.CXX_FLAGS, "-o", out,
                    os.path.join(REPO, "native", "wavio.cpp")], check=True)
    return out


def test_native_decode_matches_jax_and_the_numpy_path(wavs, jax_native,
                                                      monkeypatch):
    monkeypatch.setattr(j_wavio, "_LIB_PATH", jax_native)
    monkeypatch.setattr(j_wavio, "_lib", None)
    before = wavio.FALLBACKS
    for path, want, rate, fmt in wavs:
        got = wavio.load_waveform(path, 16000)
        assert got.dtype == np.float32 and got.shape == want.shape, path
        np.testing.assert_array_equal(
            got, j_wavio.load_waveform(path, 16000, use_native=True),
            err_msg=path)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=path)
        capped = wavio.load_waveform(path, 16000, max_samples=1000)
        np.testing.assert_array_equal(capped, got[:1000])
    assert wavio.FALLBACKS == before


def test_python_path_matches_jax(wavs):
    """The stdlib path: JAX's reads 16 and 32-bit PCM, the port's also
    24-bit; neither reads IEEE float."""
    for path, want, rate, fmt in wavs:
        if fmt == "f32":
            with pytest.raises(wave.Error):
                wavio.load_waveform(path, 16000, use_native=False)
            continue
        got = wavio.load_waveform(path, 16000, use_native=False)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=path)
        x, sr = wavio._python_read(path)
        assert sr == rate and x.dtype == np.float32
        if fmt != 24:
            jx, jsr = j_wavio._python_read(path)
            assert jsr == sr
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(
                got, j_wavio.load_waveform(path, 16000, use_native=False))


def test_parallel_load_and_the_fallback_count(wavs, tmp_path):
    paths = [p for p, *_ in wavs] * 2
    got = wavio.load_waveforms_parallel(paths, 16000, max_samples=3000,
                                        workers=4)
    for g, (_, want, _, _) in zip(got, wavs * 2):
        np.testing.assert_allclose(g, want[:3000], atol=1e-5, rtol=0)
    # a data chunk of no frames: the native decoder refuses it, the stdlib
    # path reads it, and the fallback is counted
    empty = str(tmp_path / "empty.wav")
    write_wav(empty, np.zeros((0, 1)), 16000, 16)
    before = wavio.FALLBACKS
    assert wavio.load_waveform(empty).shape == (0,)
    assert wavio.FALLBACKS == before + 1


def test_library_builds_once_atomically_from_the_port_source(tmp_path):
    assert wavio.SOURCE == os.path.join(REPO, "mme_tpu_torch", "native",
                                        "wavio.cpp")
    results = []

    def build():
        results.append(wavio.build_library(str(tmp_path)))

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    paths = {p for p, _ in results}
    commands = [c for _, c in results if c is not None]
    assert paths == {wavio.library_path(str(tmp_path))}
    assert len(commands) == 1 and commands[0][-1] == wavio.SOURCE
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(p) for p in paths]
        + [os.path.basename(p) + ".lock" for p in paths])
    assert wavio.build_library(str(tmp_path)) == (paths.pop(), None)


def test_library_name_follows_what_march_native_resolves_to(tmp_path,
                                                           monkeypatch):
    """One library per source, flags and resolved target: a CPU that
    resolves ``-march=native`` otherwise gets its own build, the same CPU
    on another host shares it."""
    assert "-march=" in wavio._native_target()
    here = wavio.library_path(str(tmp_path))
    assert here == wavio.library_path(str(tmp_path))
    monkeypatch.setattr(wavio, "_native_target",
                        lambda: "  -march=                   \tznver4\n")
    other = wavio.library_path(str(tmp_path))
    assert other != here and os.path.dirname(other) == str(tmp_path)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "wavio.cpp"
    broken.write_text("int wav_info( {\n")
    monkeypatch.setattr(wavio, "SOURCE", str(broken))
    with pytest.raises(RuntimeError, match="building the WAV decoder failed"
                       "(.|\n)*error"):
        wavio.build_library(str(tmp_path / "build"))
    assert [f for f in os.listdir(tmp_path / "build")
            if not f.endswith(".lock")] == []
