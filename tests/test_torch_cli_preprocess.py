"""The port's ``preprocess`` CLI against the JAX package's on the same
temporary inputs: every subcommand writes or returns the same thing. Files
without a resize or warp are equal; resized and warped face stores are
within one level (uint8 truncation of float32 work that rounds apart)."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_face_frontend_fidelity import draw_face

from mertools_tpu.cli import preprocess as jp
from mertools_tpu.io import video as jvio
from mertools_tpu.ops import face_detect as jd
from mertools_tpu_torch.cli import preprocess as tp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(argv_of):
    """Run both CLIs; ``argv_of(side)`` gives each its arguments and output
    location. Returns (port's result, JAX's result)."""
    return tp.main(argv_of("torch")), jp.main(argv_of("jax"))


def _npz_equal(a, b):
    za, zb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        va, vb = za[k], zb[k]
        assert (va.item() == vb.item()) if va.dtype == object else np.array_equal(va, vb)


@pytest.mark.skipif(not jvio.available(), reason="libmervideo.so not built")
def test_split_audio_equals_jax(tmp_path):
    # a child process, as test_cli_preprocess.py: libav beside jaxlib
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import numpy as np
        from mertools_tpu.io import video as vio
        from mertools_tpu.cli.preprocess import main as jmain
        from mertools_tpu_torch.cli.preprocess import main as tmain
        import os
        os.makedirs("video")
        t = np.arange(8000) / 16000.0
        tone = (0.4 * np.sin(2 * np.pi * 250 * t)).astype(np.float32)
        vio.encode_video("video/x.mp4", np.zeros((10, 32, 32, 3), np.uint8),
                         fps=20.0, audio=tone, audio_sr=16000)
        tmain(["split-audio", "--video_root=video", "--save_root=a_torch"])
        jmain(["split-audio", "--video_root=video", "--save_root=a_jax"])
        a, b = open("a_torch/x.wav", "rb").read(), open("a_jax/x.wav", "rb").read()
        assert a == b and len(a) > 8000
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path), timeout=240)
    assert res.returncode == 0, res.stderr + res.stdout


def test_find_false_audio_equals_jax(tmp_path):
    vdir, adir = tmp_path / "video", tmp_path / "audio"
    vdir.mkdir()
    adir.mkdir()
    for n in ("a", "b", "c"):
        (vdir / f"{n}.mp4").write_bytes(b"x")
    (adir / "a.wav").write_bytes(b"x")
    got, ref = _both(lambda side: [
        "find-false-audio", f"--video_root={vdir}", f"--audio_root={adir}"])
    assert got == ref and len(got) == 2


def test_make_labels_equals_jax(tmp_path):
    csv_path = tmp_path / "labels.csv"
    csv_path.write_text("name,emo,val,split\nc0,happy,1.5,train\n"
                        "c1,sad,-1.0,train\nc2,neutral,,test1\nc3,worried,0.5,\n",
                        encoding="utf-8")
    _both(lambda side: ["make-labels", f"--label_csv={csv_path}",
                        f"--save_path={tmp_path / side}.npz"])
    _npz_equal(tmp_path / "torch.npz", tmp_path / "jax.npz")


@pytest.mark.parametrize("size", [112, 64])
def test_compress_faces_equals_jax(tmp_path, size):
    """Frame directories of 112 x 112 crops; at 64 both CLIs resize."""
    root = tmp_path / "faces"
    rng = np.random.default_rng(size)
    for clip, n in (("clipA", 4), ("clipB", 2)):
        (root / clip).mkdir(parents=True)
        for i in range(n):
            np.save(root / clip / f"{i:03d}.npy",
                    rng.integers(0, 256, (112, 112, 3), dtype=np.uint8))
    (root / "empty").mkdir()
    _both(lambda side: [
        "compress-faces", f"--face_root={root}", f"--save_root={tmp_path / side}",
        f"--size={size}", *(["--device", "cpu"] if side == "torch" else [])])
    assert sorted(os.listdir(tmp_path / "torch")) == ["clipA.npy", "clipB.npy"]
    for clip in ("clipA", "clipB"):
        got = np.load(tmp_path / "torch" / f"{clip}.npy")
        ref = np.load(tmp_path / "jax" / f"{clip}.npy")
        assert got.dtype == np.uint8 and got.shape == ref.shape
        assert got.shape[1:] == (size, size, 3)
        assert np.abs(got.astype(int) - ref).max() <= (0 if size == 112 else 1)


def _face_clips(root):
    """Two clips of RGB frames as .npy files: a drawn face drifting 4 px a
    frame, and a clip without a face."""
    root.mkdir()
    rng = np.random.default_rng(5)
    frames = np.zeros((4, 220, 200, 3), np.uint8)
    for t in range(4):
        img, _ = draw_face(220, 200, 90 + 4 * t, 110, 96, 1.0, rng, 3.0)
        frames[t] = np.repeat(np.clip(img, 0, 255)[..., None], 3, -1).astype(np.uint8)
    np.save(root / "face.npy", frames)
    np.save(root / "blank.npy", np.full((2, 120, 100, 3), 90, np.uint8))


def test_detect_faces_haar_route_matches_jax(tmp_path):
    vids = tmp_path / "frames"
    _face_clips(vids)
    _both(lambda side: [
        "detect-faces", f"--video_root={vids}", f"--save_root={tmp_path / side}",
        *(["--device", "cpu"] if side == "torch" else [])])
    for clip, n in (("face", 4), ("blank", 1)):
        got = np.load(tmp_path / "torch" / f"{clip}.npy")
        ref = np.load(tmp_path / "jax" / f"{clip}.npy")
        assert got.dtype == np.uint8 and got.shape == ref.shape == (n, 112, 112, 3)
        assert np.abs(got.astype(int) - ref).max() <= 1
    assert np.load(tmp_path / "torch" / "face.npy").std() > 5


def test_detect_faces_blazeface_route_matches_jax(tmp_path):
    """The JAX package's parameter npz (width 16, seeded init) read by both
    CLIs: the same frames kept and crops within one level."""
    vids = tmp_path / "frames"
    _face_clips(vids)
    model = jd.BlazeFace(width=16)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 128, 128, 3)))["params"]
    pfile = tmp_path / "det.npz"
    np.savez(pfile, params=np.array(jax.tree_util.tree_map(np.asarray, params),
                                    dtype=object))
    for thresh in ("0.0", "0.9999"):
        _both(lambda side: [
            "detect-faces", f"--video_root={vids}",
            f"--save_root={tmp_path / side / thresh}", f"--detector_params={pfile}",
            "--detector_width=16", f"--score_thresh={thresh}",
            *(["--device", "cpu"] if side == "torch" else [])])
        for clip in ("face", "blank"):
            got = np.load(tmp_path / "torch" / thresh / f"{clip}.npy")
            ref = np.load(tmp_path / "jax" / thresh / f"{clip}.npy")
            assert got.dtype == np.uint8 and got.shape == ref.shape
            assert np.abs(got.astype(int) - ref).max() <= 1
    assert np.load(tmp_path / "torch" / "0.0" / "face.npy").shape[0] == 4


def test_scan_faces_equals_jax(tmp_path):
    for side in ("torch", "jax"):
        for name, n_frames in (("ok", 20), ("short", 3)):
            d = tmp_path / side / "faces" / name
            d.mkdir(parents=True)
            np.save(d / f"{name}.npy", np.zeros((n_frames, 4, 4, 3), np.uint8))
        (tmp_path / side / "faces" / "broken").mkdir()
    got, ref = _both(lambda side: [
        "scan-faces", f"--face_root={tmp_path / side / 'faces'}",
        f"--save_path={tmp_path / side}.npz", "--delete_short"])
    assert got == ref == {"broken": 0, "ok": 20, "short": 3}
    _npz_equal(tmp_path / "torch.npz", tmp_path / "jax.npz")
    for side in ("torch", "jax"):
        assert sorted(os.listdir(tmp_path / side / "faces")) == ["ok"]


def test_check_features_equals_jax(tmp_path):
    from mertools_tpu.data.labels import write_label_archive

    npz = tmp_path / "labels.npz"
    write_label_archive(str(npz), {"train": {
        "a": {"emo": "happy", "val": 1.0}, "b": {"emo": "sad", "val": 0.0},
        "c": {"emo": "sad", "val": 0.0}}})
    feat = tmp_path / "feat"
    feat.mkdir()
    np.save(feat / "a.npy", np.ones((5, 8), np.float32))
    np.save(feat / "c.npy", np.full((3, 8), np.nan, np.float32))
    got, ref = _both(lambda side: [
        "check-features", f"--feature_root={feat}", f"--label_npz={npz}"])
    assert got == ref == {"missing": ["b"], "bad": ["c"], "dims": [8]}
