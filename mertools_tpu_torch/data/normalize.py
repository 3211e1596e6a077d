"""Per-dataset raw-distribution -> normalized-layout converters — port of
``mertools_tpu/data/normalize.py`` (host code, copied as it is).

Reference: ``MERBench/toolkit/preprocess/{mer2023,meld,sims,simsv2,cmumosi,
cmumosei,iemocap}.py`` — each converts a raw dataset into the normalized
layout the whole toolchain consumes: ``video/`` (optional copy here),
``label*.npz`` with ``{split}_corpus`` dicts of ``{name: {emo, val}}``, and
``transcription.csv``.

Pure-data transforms only: video file copies are opt-in (``copy_videos``);
the reference's GPT-based Chinese translation of English transcripts
(cmumosi.py:20-23) is deferred to the JAX package's ``cli/translate.py``
(batched local LLM).
Clip splitting for IEMOCAP/CMU-MOSEI raw videos (time-segment re-encode,
iemocap.py:23-62) goes through ``cli/preprocess split-audio``-style native
decode/encode and is not needed when the community-segmented clips are used.
"""

from __future__ import annotations

import csv
import glob
import os
import pickle
import shutil

import numpy as np

MELD_EMOS = ["anger", "joy", "sadness", "neutral", "disgust", "fear",
             "surprise"]  # meld.py:7


def _read_csv(path: str) -> list[dict]:
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def _write_trans(path: str, names, cols: dict[str, list]):
    """transcription.csv with a name column + given language columns."""
    keys = list(cols)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["name"] + keys)
        for i, n in enumerate(names):
            w.writerow([n] + [cols[k][i] for k in keys])


def _save_corpus(path: str, corpus: dict[str, dict]):
    np.savez_compressed(path, **{f"{k}_corpus": v for k, v in corpus.items()})


def normalize_mer2023(data_root: str, save_root: str,
                      copy_videos: bool = False) -> str:
    """mer2023.py:8-52: {train,test1,test2,test3}-label.csv (name/discrete/
    valence; test3 has no valence -> -10) -> label-6way.npz."""
    os.makedirs(save_root, exist_ok=True)
    corpus = {}
    for split in ("train", "test1", "test2", "test3"):
        rows = _read_csv(os.path.join(data_root, f"{split}-label.csv"))
        corpus[split] = {}
        for r in rows:
            val = -10.0 if split == "test3" else float(r["valence"])
            corpus[split][r["name"]] = {"emo": r["discrete"], "val": val}
        if copy_videos:
            vdir = os.path.join(save_root, "video")
            os.makedirs(vdir, exist_ok=True)
            for r in rows:
                for src in glob.glob(os.path.join(data_root, split,
                                                  r["name"] + "*")):
                    shutil.copy(src, os.path.join(vdir,
                                                  os.path.basename(src)))
    out = os.path.join(save_root, "label-6way.npz")
    _save_corpus(out, corpus)
    return out


def normalize_mer2024(data_root: str, save_root: str,
                      copy_videos: bool = False) -> str:
    """MER2024/toolkit/preprocess/mer2024.py:35-79: ``video-labeled/`` +
    ``label-disdim.csv`` (name/discrete) -> train corpus; every clip in
    ``video-unlabeled-with-test2noise/`` -> test1 corpus labeled neutral
    (the semi-supervised pool doubles as the test set pre-release)."""
    os.makedirs(save_root, exist_ok=True)
    name2emo = {r["name"]: r["discrete"]
                for r in _read_csv(os.path.join(data_root,
                                                "label-disdim.csv"))}

    def clip_names(vdir):
        return sorted({os.path.basename(p).rsplit(".", 1)[0]
                       for p in glob.glob(os.path.join(vdir, "*"))})

    train_dir = os.path.join(data_root, "video-labeled")
    test_dir = os.path.join(data_root, "video-unlabeled-with-test2noise")
    corpus = {
        "train": {n: {"emo": name2emo[n]} for n in clip_names(train_dir)},
        "test1": {n: {"emo": "neutral"} for n in clip_names(test_dir)},
    }
    if copy_videos:
        vdir = os.path.join(save_root, "video")
        os.makedirs(vdir, exist_ok=True)
        for src_dir in (train_dir, test_dir):
            for src in glob.glob(os.path.join(src_dir, "*")):
                shutil.copy(src, os.path.join(vdir, os.path.basename(src)))
    out = os.path.join(save_root, "label-6way.npz")
    _save_corpus(out, corpus)
    return out


def scan_face_store(face_root: str, save_path: str | None = None,
                    min_frames: int = 16, delete_short: bool = False):
    """MER2024/toolkit/preprocess/mer2023_unlabel.py:8-36: scan an
    ``openface_face`` store (``{name}/{name}.npy`` per clip), record frame
    counts, and flag/drop clips with <= ``min_frames`` usable faces (the
    reference prunes these from the 74k unlabeled pretraining pool).

    Returns (name2len, short_names)."""
    name2len, short = {}, []
    for face_dir in sorted(glob.glob(os.path.join(face_root, "*"))):
        name = os.path.basename(face_dir)
        npy = os.path.join(face_dir, name + ".npy")
        try:
            n = len(np.load(npy, mmap_mode="r"))
        except Exception:
            n = 0
        name2len[name] = n
        if n <= min_frames:
            short.append(name)
            if delete_short:
                shutil.rmtree(face_dir)
    if save_path:
        np.savez_compressed(save_path, name2len=name2len)
    return name2len, short


def normalize_meld(data_root: str, save_root: str,
                   copy_videos: bool = False) -> str:
    """meld.py:14-87: {train,dev,test}_sent_emo.csv -> names
    ``{split}_dia{D}_utt{U}``, 7-way emotion indices, val=-10, English
    transcription.csv."""
    os.makedirs(save_root, exist_ok=True)
    emo2idx = {e: i for i, e in enumerate(MELD_EMOS)}
    corpus, names, engs = {}, [], []
    for split, fname, vdir in (("train", "train_sent_emo.csv", "train"),
                               ("val", "dev_sent_emo.csv", "dev"),
                               ("test", "test_sent_emo.csv", "test")):
        rows = _read_csv(os.path.join(data_root, fname))
        corpus[split] = {}
        for r in rows:
            base = f"dia{r['Dialogue_ID']}_utt{r['Utterance_ID']}"
            newname = f"{split}_{base}"
            corpus[split][newname] = {"emo": emo2idx[r["Emotion"].lower()],
                                      "val": -10}
            names.append(newname)
            engs.append(r["Utterance"])
            if copy_videos:
                src = os.path.join(data_root, vdir, base + ".mp4")
                dst_dir = os.path.join(save_root, "subvideo")
                os.makedirs(dst_dir, exist_ok=True)
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(dst_dir, newname + ".mp4"))
    _save_corpus(os.path.join(save_root, "label.npz"), corpus)
    _write_trans(os.path.join(save_root, "transcription.csv"), names,
                 {"english": engs})
    return os.path.join(save_root, "label.npz")


def normalize_sims(data_root: str, save_root: str,
                   copy_videos: bool = False) -> str:
    """sims.py:15-100: metadata/sentiment/label_M.csv + {split}_index.csv
    subsets + metadata/Translation.csv; names ``{video_id}_{clip:04d}``,
    emo=0, val=sentiment label."""
    os.makedirs(save_root, exist_ok=True)
    rows = _read_csv(os.path.join(data_root, "metadata/sentiment",
                                  "label_M.csv"))
    all_names = [f"{r['video_id']}_{int(r['clip_id']):04d}" for r in rows]
    all_vals = [float(r["label"]) for r in rows]
    corpus = {}
    for split in ("train", "val", "test"):
        idx = [int(r["index"]) for r in _read_csv(
            os.path.join(data_root, "metadata", f"{split}_index.csv"))]
        corpus[split] = {all_names[i]: {"emo": 0, "val": all_vals[i]}
                         for i in idx}
    trans = _read_csv(os.path.join(data_root, "metadata", "Translation.csv"))
    tnames = [f"{r['video_id']}_{int(r['clip_id']):04d}" for r in trans]
    _write_trans(os.path.join(save_root, "transcription.csv"), tnames,
                 {"chinese": [r["Chinese"] for r in trans],
                  "english": [r["English"] for r in trans]})
    if copy_videos:
        vdir = os.path.join(save_root, "video")
        os.makedirs(vdir, exist_ok=True)
        for r, name in zip(rows, all_names):
            src = os.path.join(data_root, "Raw", r["video_id"],
                               f"{int(r['clip_id']):04d}.mp4")
            if os.path.exists(src):
                shutil.copy(src, os.path.join(vdir, name + ".mp4"))
    _save_corpus(os.path.join(save_root, "label.npz"), corpus)
    return os.path.join(save_root, "label.npz")


def normalize_simsv2(data_root: str, save_root: str,
                     copy_videos: bool = False) -> str:
    """simsv2.py:14-76: single meta.csv with video_id/clip_id/text/label/mode
    (mode in train/valid/test); names ``{video_id}_{clip_id}``."""
    os.makedirs(save_root, exist_ok=True)
    rows = _read_csv(os.path.join(data_root, "meta.csv"))
    corpus = {"train": {}, "val": {}, "test": {}}
    names, chis = [], []
    for r in rows:
        name = f"{r['video_id']}_{r['clip_id']}"
        split = {"train": "train", "valid": "val", "test": "test"}[r["mode"]]
        corpus[split][name] = {"emo": 0, "val": float(r["label"])}
        names.append(name)
        chis.append(r["text"])
        if copy_videos:
            src = os.path.join(data_root, "Raw", r["video_id"],
                               r["clip_id"] + ".mp4")
            vdir = os.path.join(save_root, "video")
            os.makedirs(vdir, exist_ok=True)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(vdir, name + ".mp4"))
    _write_trans(os.path.join(save_root, "transcription.csv"), names,
                 {"chinese": chis})
    _save_corpus(os.path.join(save_root, "label.npz"), corpus)
    return os.path.join(save_root, "label.npz")


def _cmu_pkl(label_pkl: str):
    with open(label_pkl, "rb") as f:
        return pickle.load(f, encoding="latin1")


def normalize_cmu(label_pkl: str, save_root: str) -> str:
    """cmumosi.py:32-88 / cmumosei.py:87-130: the community 7-tuple pkl
    (videoIDs, videoLabels, _, videoSentences, trainVids, valVids, testVids)
    -> label.npz (emo=0, val=sentiment) + English transcription.csv (the
    reference additionally GPT-translates to Chinese — the JAX package's
    cli/translate does that)."""
    os.makedirs(save_root, exist_ok=True)
    videoIDs, videoLabels, _, videoSentences, trainVids, valVids, testVids \
        = _cmu_pkl(label_pkl)
    corpus = {}
    for split, vids in (("train", trainVids), ("val", valVids),
                        ("test", testVids)):
        corpus[split] = {}
        for vid in vids:
            for name, label in zip(videoIDs[vid], videoLabels[vid]):
                corpus[split][name] = {"emo": 0, "val": float(label)}
    names, engs = [], []
    for vid in videoIDs:
        names.extend(videoIDs[vid])
        engs.extend(videoSentences[vid])
    _write_trans(os.path.join(save_root, "transcription.csv"), names,
                 {"english": engs})
    _save_corpus(os.path.join(save_root, "label.npz"), corpus)
    return os.path.join(save_root, "label.npz")


def normalize_iemocap(label_pkl: str, save_root: str,
                      data_root: str | None = None,
                      ways: int = 4) -> str:
    """iemocap.py:64-107: 6-tuple pkl (videoIDs, videoLabels, _, _,
    trainVids, testVids) -> whole_corpus npz (CV splits are built later by
    the session-based loader); transcripts parsed from the session dialog
    txt files when ``data_root`` is given."""
    os.makedirs(save_root, exist_ok=True)
    with open(label_pkl, "rb") as f:
        videoIDs, videoLabels, _, _, trainVids, testVids = \
            pickle.load(f, encoding="latin1")
    whole = {}
    for vid in sorted(trainVids | testVids):
        for name, label in zip(videoIDs[vid], videoLabels[vid]):
            whole[name] = {"emo": int(label), "val": -10}
    out = os.path.join(save_root, f"label-{ways}way.npz")
    np.savez_compressed(out, whole_corpus=whole)

    if data_root:
        names, sentences = [], []
        for sess in range(1, 6):
            pattern = os.path.join(data_root, f"Session{sess}",
                                   "dialog/transcriptions", "S*.txt")
            for trans_path in sorted(glob.glob(pattern)):
                with open(trans_path, encoding="utf8") as f:
                    for line in f:
                        line = line.strip()
                        # "Ses05F_script03_1_F033 [241.67-243.40]: text"
                        if "]:" not in line or " [" not in line:
                            continue
                        try:
                            subname = line.split(" [")[0]
                            sentence = line.split("]:")[1].strip()
                        except IndexError:
                            continue
                        names.append(subname)
                        sentences.append(sentence)
        _write_trans(os.path.join(save_root, "transcription.csv"), names,
                     {"english": sentences})
    return out


def _normalize_track1(data_root: str, save_root: str, train_csv: str,
                      test_csv: str, candidate_csv: str,
                      copy_videos: bool = False,
                      with_gt: bool | None = None) -> str:
    """Shared MER2025-T1 / MER2026-T1 layout (toolkit/preprocess/
    mer2025.py:31-66 / mer2026.py:33-66): train csv (name,discrete) ->
    train corpus; test csv with gt OR the candidate csv labeled neutral ->
    test1 corpus; label npz = track1_label_6way.npz; the subtitle csv
    passes through as track1_subtitle_chieng.csv."""
    os.makedirs(save_root, exist_ok=True)
    train = {r["name"]: {"emo": r["discrete"]}
             for r in _read_csv(os.path.join(data_root, train_csv))}
    if with_gt is None:
        with_gt = os.path.exists(os.path.join(data_root, test_csv))
    if with_gt:
        test = {r["name"]: {"emo": r["discrete"]}
                for r in _read_csv(os.path.join(data_root, test_csv))}
    else:  # no labels pre-release: every candidate is 'neutral'
        test = {r["name"]: {"emo": "neutral"}
                for r in _read_csv(os.path.join(data_root, candidate_csv))}
    sub_src = os.path.join(data_root, "subtitle_chieng.csv")
    if os.path.exists(sub_src):
        shutil.copy(sub_src, os.path.join(save_root,
                                          "track1_subtitle_chieng.csv"))
    if copy_videos:
        vdir_src = os.path.join(data_root, "video")
        vdir = os.path.join(save_root, "video")
        if os.path.isdir(vdir_src):
            os.makedirs(vdir, exist_ok=True)
            for src in glob.glob(os.path.join(vdir_src, "*")):
                shutil.copy(src, os.path.join(vdir, os.path.basename(src)))
    out = os.path.join(save_root, "track1_label_6way.npz")
    _save_corpus(out, {"train": train, "test1": test})
    return out


def normalize_mer2025(data_root: str, save_root: str,
                      copy_videos: bool = False) -> str:
    """MER2025-T1 (toolkit/preprocess/mer2025.py:31-66)."""
    return _normalize_track1(data_root, save_root,
                             "track1_train_disdim.csv", "track1_test_dis.csv",
                             "track_all_candidates.csv",
                             copy_videos=copy_videos)


def normalize_mer2026(data_root: str, save_root: str,
                      copy_videos: bool = False) -> str:
    """MER2026-T1 interlocutor track (toolkit/preprocess/mer2026.py:33-66) —
    the listener-emotion labels are pure data; the layout is identical."""
    return _normalize_track1(data_root, save_root,
                             "track1_train.csv", "track1_test.csv",
                             "track1_track2_candidate.csv",
                             copy_videos=copy_videos)


NORMALIZERS = {
    "mer2023": normalize_mer2023,
    "mer2024": normalize_mer2024,
    "mer2025": normalize_mer2025,
    "mer2026": normalize_mer2026,
    "meld": normalize_meld,
    "sims": normalize_sims,
    "simsv2": normalize_simsv2,
    "cmumosi": normalize_cmu,
    "cmumosei": normalize_cmu,
    "iemocap": normalize_iemocap,
}
