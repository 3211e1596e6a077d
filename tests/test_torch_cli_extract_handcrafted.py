"""The port's extract_handcrafted CLI against the JAX package's on the same
PCM16 wavs (the shared seeded batch, ``test_torch_handcrafted.clip_batch``,
written at its lengths, so both CLIs run one (6, 32000) bucket): every set
at both levels writes the JAX store's names and shapes, with values within
the parity files' tolerances and the discrete outputs equal (IS10's and
IS13's functionals as ``hc_gates.hc_explain`` holds them, on both
packages' contours of the wavs read back, the entries off the tolerance
pinned); the resume rule."""

import collections
import hashlib
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mertools_tpu.cli import extract_handcrafted as jcli
from mertools_tpu.ops import opensmile_is10 as j10
from mertools_tpu.ops import opensmile_is13 as j13
from mertools_tpu_torch.cli import extract_handcrafted as tcli
from mertools_tpu_torch.io import wav as wav_io
from mertools_tpu_torch.ops import egemaps as te
from mertools_tpu_torch.ops import opensmile_is10 as t10
from mertools_tpu_torch.ops import opensmile_is13 as t13
from hc_gates import hc_explain
from test_torch_egemaps import assert_frames_close, assert_utt_close
from test_torch_handcrafted import TOL, assert_columns_close, clip_batch
from test_torch_opensmile_is09 import MOMENTS, POS_COLS
from test_torch_opensmile_is10 import jax_engine as is10_engine
from test_torch_opensmile_is13 import jax_engine as is13_engine

torch.set_num_threads(1)

SETS = ("mel_spec", "mfcc", "IS09", "eGeMAPS", "IS10", "IS13")
LEVELS = ("UTTERANCE", "FRAME")
TAG = {"UTTERANCE": "UTT", "FRAME": "FRA"}
DIMS = {("mel_spec", "UTTERANCE"): 128, ("mel_spec", "FRAME"): 128,
        ("mfcc", "UTTERANCE"): 120, ("mfcc", "FRAME"): 120,
        ("IS09", "UTTERANCE"): 384, ("IS09", "FRAME"): 32,
        ("eGeMAPS", "UTTERANCE"): 88, ("eGeMAPS", "FRAME"): 23,
        ("IS10", "UTTERANCE"): 1582, ("IS10", "FRAME"): 32,
        ("IS13", "UTTERANCE"): 6372, ("IS13", "FRAME"): 120}

# The IS10 / IS13 UTT entries off 2e-4 of the JAX CLI's, each with the
# account ``hc_explain`` gives it: the count of each (clip, account), and
# the sha256 of the sorted (column, clip, account) list, which pins the set
# exactly (as tests/test_torch_opensmile_is13.py names the direct batch's).
CLI_OFF = {
    "IS10": ({(1, "tie"): 1},
             "c34113147514362c38ecd79ac59eabe97daf2b005b92262ceeac083ec57b5a84"),
    "IS13": ({(0, "contours"): 42, (0, "lp"): 124, (1, "contours"): 9, (1, "lp"): 8,
              (1, "tie"): 1, (2, "contours"): 5, (2, "lp"): 5, (3, "contours"): 1},
             "bf09ce22e9231334b2a4486e325e0a772fa2ab5fcebfbc14875f1dc57e217b33")}


def contour_blocks(root, names, fs):
    """Both packages' IS10 or IS13 contours of the wavs as the CLIs read and
    batch them (one 2 s bucket in file order), as ``functional_blocks``
    gives them."""
    reads = [wav_io.read_wav_16k(str(root / "audio" / f"{n}.wav")) for n in sorted(names)]
    wavs = np.zeros((len(reads), 32000), np.float32)
    for i, w in enumerate(reads):
        wavs[i, :len(w)] = w
    lengths = np.array([len(w) for w in reads])
    x, n = torch.from_numpy(wavs), torch.from_numpy(lengths)
    if fs == "IS10":
        mod, port = t10, t10._lld_core(x, n)
        theirs = tuple(torch.from_numpy(np.array(a)) for a in j10._lld_core(
            jnp.asarray(wavs), jnp.asarray(lengths)))
    else:
        mod, port = t13, t13._lld_core(x, n)
        llds, voiced, mask = j13._lld_core(jnp.asarray(wavs), jnp.asarray(lengths))
        theirs = ({k: torch.from_numpy(np.array(v)) for k, v in llds.items()},
                  torch.from_numpy(np.array(voiced)), torch.from_numpy(np.array(mask)))
    return mod.functional_blocks(*port), mod.functional_blocks(*theirs)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("handcrafted")
    wav, lengths = clip_batch()
    audio = root / "audio"
    audio.mkdir()
    names = [f"clip{i}" for i in range(len(lengths))]
    for name, w, n in zip(names, wav, lengths):
        wav_io.write_wav(str(audio / f"{name}.wav"), w[:n])
    for fs in SETS:
        for level in LEVELS:
            args = [f"--feature_set={fs}", f"--feature_level={level}",
                    f"--audio_dir={audio}"]
            jcli.main(args + [f"--save_dir={root / 'jax'}"])
            tcli.main(args + [f"--save_dir={root / 'port'}", "--device", "cpu"])
    return root, names


def _read(d, names):
    return [np.load(os.path.join(d, f"{n}.npy")) for n in names]


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("fs", SETS)
def test_stores_match_the_jax_cli(stores, fs, level):
    root, names = stores
    store = f"{fs}-{TAG[level]}"
    assert sorted(os.listdir(root / "port" / store)) == sorted(os.listdir(root / "jax" / store))
    got, want = _read(root / "port" / store, names), _read(root / "jax" / store, names)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[-1] == DIMS[fs, level] and np.isfinite(g).all()
    if fs == "IS09" and level == "UTTERANCE":
        got, want = np.stack(got), np.stack(want)
        np.testing.assert_array_equal(got[:, POS_COLS], want[:, POS_COLS])
        assert_columns_close(got, want, floor=MOMENTS)
    elif fs == "eGeMAPS" and level == "UTTERANCE":
        assert_utt_close(np.stack(got), np.stack(want))
    elif fs in ("IS10", "IS13") and level == "UTTERANCE":
        assert sorted(names) == names
        engine = is10_engine if fs == "IS10" else is13_engine
        worst, explained = hc_explain(fs, np.stack(got), np.stack(want),
                                      *contour_blocks(root, names, fs), engine, TOL, "CLI")
        assert worst <= 1.0
        entries = sorted((name, clip, how) for name, clip, how, *_ in explained)
        counts, digest = CLI_OFF[fs]
        assert collections.Counter(e[1:] for e in entries) == counts
        assert hashlib.sha256(repr(entries).encode()).hexdigest() == digest
    else:
        got, want = np.concatenate(got), np.concatenate(want)
        if fs == "eGeMAPS":
            f0 = te.LLD_NAMES.index("F0semitone")
            np.testing.assert_array_equal(got[:, f0], want[:, f0])
            assert_frames_close(got, want)
        else:
            if fs == "IS09":        # the voicing decision
                np.testing.assert_array_equal(got[:, 3] > 0, want[:, 3] > 0)
            assert_columns_close(got, want)


def test_frame_rows_follow_the_jax_rules(stores):
    """FRAME rows: the complete frames for the openSMILE sets (at least
    one), ``len // 160 + 1`` for librosa's."""
    root, names = stores
    _, lengths = clip_batch()
    for fs, rows in (("IS09", lambda n: max(1 + (n - 400) // 160, 1)),
                     ("eGeMAPS", te.n_frames), ("mfcc", lambda n: n // 160 + 1)):
        got = [a.shape[0] for a in _read(root / "port" / f"{fs}-FRA", names)]
        assert got == [rows(int(n)) for n in lengths], fs


def test_resume_skips_stored_clips(stores, tmp_path):
    """A clip whose store file exists is not extracted again; the others
    are, into the same store."""
    root, names = stores
    save = tmp_path / "f"
    store = save / "IS09-UTT"
    store.mkdir(parents=True)
    marker = np.full(384, 7.0, np.float32)
    np.save(store / "clip0.npy", marker)
    tcli.main(["--feature_set=IS09", f"--audio_dir={root / 'audio'}", f"--save_dir={save}",
               "--device", "cpu"])
    np.testing.assert_array_equal(np.load(store / "clip0.npy"), marker)
    assert sorted(os.listdir(store)) == sorted(f"{n}.npy" for n in names)
    np.testing.assert_array_equal(np.load(store / "clip1.npy"),
                                  np.load(root / "port" / "IS09-UTT" / "clip1.npy"))


def test_device_defaults_to_the_card(stores, tmp_path, monkeypatch):
    """Without ``--device`` the CLI asks for CUDA, and on a host without a
    card it refuses rather than fall back to the CPU."""
    root, _ = stores
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--feature_set=mfcc", f"--audio_dir={root / 'audio'}",
                   f"--save_dir={tmp_path}"])
