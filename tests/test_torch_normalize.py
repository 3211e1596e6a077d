"""The port's dataset converters (``data/normalize.py``, through the
``normalize-dataset`` subcommand) against the JAX package's, on the raw
layouts of ``tests/test_normalize_datasets.py``: every file each writes is
equal."""

import csv
import os
import pickle

import numpy as np
import pytest

from mertools_tpu.cli.preprocess import main as jmain
from mertools_tpu_torch.cli.preprocess import main as tmain


def _wcsv(path, header, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _meld(root):
    for split, fname in (("train", "train_sent_emo.csv"),
                         ("dev", "dev_sent_emo.csv"),
                         ("test", "test_sent_emo.csv")):
        _wcsv(os.path.join(root, fname),
              ["Dialogue_ID", "Utterance_ID", "Emotion", "Utterance"],
              [[0, 0, "joy", f"{split} hello"], [0, 1, "anger", "grr"]])
        os.makedirs(os.path.join(root, split), exist_ok=True)
        open(os.path.join(root, split, "dia0_utt0.mp4"), "w").close()
    return ["--copy_videos"]


def _simsv2(root):
    _wcsv(os.path.join(root, "meta.csv"),
          ["video_id", "clip_id", "text", "label", "mode"],
          [["vidA", "0001", "ni hao", 0.6, "train"],
           ["vidA", "0002", "zai jian", -0.2, "valid"],
           ["vidB", "0001", "xie xie", 0.0, "test"]])
    return []


def _sims(root):
    _wcsv(os.path.join(root, "metadata/sentiment/label_M.csv"),
          ["video_id", "clip_id", "label"],
          [["v1", "1", 0.4], ["v1", "2", -0.8], ["v2", "1", 0.0]])
    for split, idx in (("train", [0]), ("val", [1]), ("test", [2])):
        _wcsv(os.path.join(root, "metadata", f"{split}_index.csv"),
              ["index"], [[i] for i in idx])
    _wcsv(os.path.join(root, "metadata/Translation.csv"),
          ["video_id", "clip_id", "Chinese", "English"],
          [["v1", "1", "chi1", "eng1"], ["v1", "2", "chi2", "eng2"],
           ["v2", "1", "chi3", "eng3"]])
    return []


def _cmu(root):
    os.makedirs(root)
    pkl = os.path.join(root, "cmu.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(({"vidA": ["vidA_1", "vidA_2"], "vidB": ["vidB_1"]},
                     {"vidA": [0.5, -0.5], "vidB": [1.5]}, None,
                     {"vidA": ["hi", "bye"], "vidB": ["ok"]},
                     {"vidA"}, set(), {"vidB"}), f)
    return [f"--label_pkl={pkl}"]


def _iemocap(root):
    os.makedirs(root)
    pkl = os.path.join(root, "iemocap.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(({"d1": ["Ses01F_impro01_F000"]}, {"d1": [2]},
                     None, None, {"d1"}, set()), f)
    raw = os.path.join(root, "Session1", "dialog", "transcriptions")
    os.makedirs(raw)
    with open(os.path.join(raw, "Ses01F_impro01.txt"), "w") as f:
        f.write("Ses01F_impro01_F000 [006.2901-008.2357]: Excuse me.\nBADLINE\n")
    return [f"--label_pkl={pkl}", "--ways=4"]


def _mer2023(root):
    for split in ("train", "test1", "test2", "test3"):
        _wcsv(os.path.join(root, f"{split}-label.csv"),
              ["name", "discrete", "valence"],
              [[f"{split}_c1", "happy", 2.5], [f"{split}_c2", "sad", -1.0]])
    return []


def _mer2024(root):
    _wcsv(os.path.join(root, "label-disdim.csv"),
          ["name", "discrete", "valence"],
          [["clipA", "happy", 0.5], ["clipB", "sad", -0.5]])
    os.makedirs(os.path.join(root, "video-labeled"))
    os.makedirs(os.path.join(root, "video-unlabeled-with-test2noise"))
    for n in ("clipA", "clipB"):
        open(os.path.join(root, "video-labeled", n + ".mp4"), "w").close()
    open(os.path.join(root, "video-unlabeled-with-test2noise", "u1.avi"), "w").close()
    return ["--copy_videos"]


def _mer2025(root):
    os.makedirs(root)
    with open(os.path.join(root, "track1_train_disdim.csv"), "w") as f:
        f.write("name,discrete,valence\nt0,happy,0.5\nt1,sad,-0.5\n")
    with open(os.path.join(root, "track_all_candidates.csv"), "w") as f:
        f.write("name\nc0\nc1\nc2\n")
    with open(os.path.join(root, "subtitle_chieng.csv"), "w") as f:
        f.write("name,chinese,english\nt0,x,hello\n")
    return []


def _mer2026(root):
    os.makedirs(os.path.join(root, "video"))
    with open(os.path.join(root, "track1_train.csv"), "w") as f:
        f.write("name,discrete\ni0,angry\n")
    with open(os.path.join(root, "track1_test.csv"), "w") as f:
        f.write("name,discrete\nj0,worried\n")
    open(os.path.join(root, "video", "i0.mp4"), "w").close()
    return ["--copy_videos"]


RAW = {"meld": _meld, "simsv2": _simsv2, "sims": _sims, "cmumosi": _cmu,
       "cmumosei": _cmu, "iemocap": _iemocap, "mer2023": _mer2023,
       "mer2024": _mer2024, "mer2025": _mer2025, "mer2026": _mer2026}


def _files(root) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = p
    return out


@pytest.mark.parametrize("dataset", sorted(RAW))
def test_normalize_dataset_files_equal_jax(tmp_path, dataset):
    raw = str(tmp_path / "raw")
    extra = [f"--data_root={raw}", *RAW[dataset](raw)]
    for side, main in (("torch", tmain), ("jax", jmain)):
        main(["normalize-dataset", f"--dataset={dataset}",
              f"--save_root={tmp_path / side}", *extra])
    got, ref = _files(tmp_path / "torch"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(ref) and got
    for rel in ref:
        if rel.endswith(".npz"):
            za, zb = np.load(got[rel], allow_pickle=True), np.load(ref[rel], allow_pickle=True)
            assert sorted(za.files) == sorted(zb.files)
            for k in zb.files:
                assert za[k].item() == zb[k].item()
        else:
            assert open(got[rel], "rb").read() == open(ref[rel], "rb").read(), rel
