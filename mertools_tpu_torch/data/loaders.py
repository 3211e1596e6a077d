"""Per-dataset loader classes (port of ``mertools_tpu/data/loaders.py``;
reference ``MERBench/toolkit/dataloader/*``).

Each loader declares the dataset's protocol — output dims, metric, CV
scheme — and builds :class:`FeatureDataset` objects from the feature store:

| dataset          | classes | valence | metric   | CV scheme                    |
|------------------|---------|---------|----------|------------------------------|
| MER2023/MER2024  | 6       | yes     | emoval   | 5-fold random + test1..3     |
| MER2025/MER2026  | 6       | no*     | emo      | 5-fold random (+ test sets)  |
| IEMOCAPFour/Six  | 4/6     | no      | emo      | 5-fold by session prefix     |
| MELD             | 7       | no      | emo      | fixed train/val/test         |
| CMUMOSI/CMUMOSEI | —       | yes     | emo(±)   | fixed train/val/test         |
| SIMS/SIMSv2      | —       | yes     | emo(±)   | fixed train/val/test         |

"emo(±)" = accuracy/WAF of the valence *sign* over non-zero labels
(cmudata.py:74-77 / sims.py:69-77). The metrics are the port's numpy ones.
Under ``--fusion_topn`` a loader builds :class:`TopNFeatureDataset`s, and
under ``--model=e2e_model`` :class:`.e2e_dataset.E2EDataset`s of raw
inputs (``--raw_audio_root``, ``--trans_csv``, ``--face_npy_root``); the
videomae branch of the JAX loaders waits for ROADMAP A7b.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.config import Args, configure_from_env
from ..core.registry import registry
from ..ops import metrics
from . import cv as cv_mod
from . import labels as labels_mod
from .dataset import FeatureDataset, TopNFeatureDataset, snr_variant


def calc_results_emoval(emo_probs=None, emo_labels=None, val_preds=None, val_labels=None):
    return metrics.calculate_results(emo_probs, emo_labels, val_preds, val_labels)


def calc_results_val_sign(emo_probs=None, emo_labels=None, val_preds=None, val_labels=None):
    """CMU/SIMS metric: binarize valence sign over non-zero labels."""
    val_preds = np.asarray(val_preds).reshape(-1)
    val_labels = np.asarray(val_labels).reshape(-1)
    non_zeros = val_labels != 0
    vl, vp = val_labels[non_zeros] > 0, val_preds[non_zeros] > 0
    return {
        "valpreds": val_preds,
        "vallabels": val_labels,
        "valmse": metrics.mean_squared_error(val_labels, val_preds),
        "emoacc": metrics.accuracy(vl, vp),
        "emofscore": metrics.weighted_f1(vl, vp),
    }


class BaseLoader:
    """Common machinery; subclasses set protocol class attrs."""

    num_folder = 5
    output_dim1 = 6
    output_dim2 = 1
    metric_name = "emoval"
    test_splits = ("test1", "test2", "test3")
    fixed_eval_split: str | None = None  # e.g. "val" for MELD/CMU
    calc_results = staticmethod(calc_results_emoval)

    def __init__(self, args: Args):
        self.args = args
        args.output_dim1 = self.output_dim1
        args.output_dim2 = self.output_dim2
        args.metric_name = self.metric_name
        args.num_folder = self.num_folder

    # -- label IO -----------------------------------------------------------
    def read_split(self, label_path: str, split: str):
        return labels_mod.read_names_labels(label_path, split, debug=bool(self.args.debug))

    def _build(self, names, emos, vals, snr: str | None = None):
        a = self.args
        if a.model == "videomae_pretrain":
            raise SystemExit("--model=videomae_pretrain: its raw-video dataset "
                             "and model are not ported to mertools_tpu_torch "
                             "yet (ROADMAP A7b, on the port's VideoMAE)")
        if a.model == "e2e_model":  # raw-input fine-tuning (e2e_data.py)
            return self._build_e2e(names, emos, vals)
        if a.fusion_topn:  # top-N fusion (MER2024 feat_data_topn.py)
            ds = TopNFeatureDataset.build(
                names, emos, vals, a.features_root, int(a.fusion_topn),
                a.fusion_modality or "AVT", snr=snr)
            a.feat_dims = ds.feat_dims
            return ds

        def root(r):  # noise sweep: snr-tagged feature dirs
            if not snr or r is None:
                return r
            head, tail = os.path.split(r)
            return os.path.join(head, snr_variant(tail, snr))

        return FeatureDataset.build(
            names, emos, vals, root(a.audio_root), root(a.text_root),
            root(a.video_root),
            feat_type=a.feat_type or "utt", feat_scale=a.feat_scale or 1)

    def _build_e2e(self, names, emos, vals):
        """The JAX loader's e2e branch: ``--e2e_nseg`` windows of
        ``--e2e_seglen`` samples a wav, the transcripts through the
        encoder's tokenizer (``core.checkpoint.load_tokenizer`` of
        ``{pretrain_dir}/{e2e_name}``), or 16 uint8 face frames a clip."""
        from ..core import checkpoint
        from ..models.e2e_model import e2e_modality
        from .e2e_dataset import E2EDataset

        a = self.args
        modality = e2e_modality(a.e2e_name)
        if modality == "audio":
            return E2EDataset.build_audio(names, emos, vals, a.raw_audio_root,
                                          n_seg=a.get("e2e_nseg") or 8,
                                          seg_len=a.get("e2e_seglen") or 32000)
        if modality == "text":
            pretrain = a.get("pretrain_dir")
            tok = checkpoint.load_tokenizer(
                os.path.join(pretrain, a.e2e_name) if pretrain else a.e2e_name)
            return E2EDataset.build_text(names, emos, vals, a.trans_csv, tok)
        return E2EDataset.build_video(names, emos, vals, a.face_npy_root)

    # -- protocol -----------------------------------------------------------
    def load(self, seed: int = 0):
        """Returns (train_set, folds, test_sets)."""
        a = self.args
        label_path = a.label_path
        train_snr, test_snr = a.train_snr, a.test_snr
        if self.fixed_eval_split:
            tr = self.read_split(label_path, "train")
            ev = self.read_split(label_path, self.fixed_eval_split)
            names = list(tr[0]) + list(ev[0])
            emos = np.concatenate([tr[1], ev[1]])
            vals = np.concatenate([tr[2], ev[2]])
            train_set = self._build(names, emos, vals, snr=train_snr)
            folds = [(np.arange(len(tr[0])), np.arange(len(tr[0]), len(names)))]
            test_sets = {s: self._build(*self.read_split(label_path, s),
                                        snr=test_snr)
                         for s in self.test_splits}
            return train_set, folds, test_sets

        tr = self.read_split(label_path, "train")
        train_set = self._build(*tr, snr=train_snr)
        folds = self.make_folds(tr[0], seed)
        test_sets = {}
        for s in self.test_splits:
            try:
                test_sets[s] = self._build(*self.read_split(label_path, s),
                                           snr=test_snr)
            except KeyError:
                pass  # split absent in this archive
        return train_set, folds, test_sets

    def make_folds(self, names, seed):
        rng = np.random.default_rng(seed)
        return cv_mod.kfold_indices(len(names), self.num_folder, rng)


@registry.register_dataset("MER2023")
class MER2023Loader(BaseLoader):
    pass


@registry.register_dataset("MER2024")
class MER2024Loader(BaseLoader):
    pass


@registry.register_dataset("MER2025")
class MER2025Loader(BaseLoader):
    output_dim2 = 0
    metric_name = "emo"
    test_splits = ("test",)


@registry.register_dataset("MER2026")
class MER2026Loader(MER2025Loader):
    """Track1 incl. the interlocutor-emotion variant: identical protocol,
    different label CSVs (MER2026/MER2026_Track1/README.md)."""


@registry.register_dataset("MELD")
class MELDLoader(BaseLoader):
    num_folder = 1
    output_dim1 = 7
    output_dim2 = 0
    metric_name = "emo"
    fixed_eval_split = "val"
    test_splits = ("test",)


class _IEMOCAPBase(BaseLoader):
    output_dim2 = 0
    metric_name = "emo"
    test_splits = ()

    def make_folds(self, names, seed):
        """Leave-one-session-out: session id is char 4 of the clip name
        (iemocap.py:84-99, e.g. Ses01F_... -> session 0)."""
        sessions = {}
        for idx, name in enumerate(names):
            sessions.setdefault(int(name[4]) - 1, []).append(idx)
        assert len(sessions) == self.num_folder, sessions.keys()
        folds = []
        for s in range(self.num_folder):
            ev = np.array(sessions[s])
            tr = np.concatenate([np.array(sessions[j]) for j in range(self.num_folder) if j != s])
            folds.append((tr, ev))
        return folds

    def read_split(self, label_path, split):
        # IEMOCAP stores one 'whole_corpus'
        return labels_mod.read_names_labels(label_path, "whole", debug=bool(self.args.debug))


@registry.register_dataset("IEMOCAPFour")
class IEMOCAPFourLoader(_IEMOCAPBase):
    output_dim1 = 4


@registry.register_dataset("IEMOCAPSix")
class IEMOCAPSixLoader(_IEMOCAPBase):
    output_dim1 = 6


class _CMUBase(BaseLoader):
    num_folder = 1
    output_dim1 = 0
    output_dim2 = 1
    metric_name = "emo"  # reference sorts by the sign-binarized WAF
    fixed_eval_split = "val"
    test_splits = ("test",)
    calc_results = staticmethod(calc_results_val_sign)


@registry.register_dataset("CMUMOSI")
class CMUMOSILoader(_CMUBase):
    pass


@registry.register_dataset("CMUMOSEI")
class CMUMOSEILoader(_CMUBase):
    pass


@registry.register_dataset("SIMS")
class SIMSLoader(_CMUBase):
    pass


@registry.register_dataset("SIMSv2")
class SIMSv2Loader(_CMUBase):
    pass


def get_loader(args: Args) -> BaseLoader:
    if args.train_dataset:  # cross-corpus dispatch (dataloader/__init__.py:18-36)
        if not args.test_dataset:
            raise SystemExit("--test_dataset required with --train_dataset")
        from_dim = args.train_dataset in DIM_DATASETS
        if (args.test_dataset in DIM_DATASETS) != from_dim:
            raise SystemExit("train/test datasets must both be dimensional "
                             "or both discrete")
        name = "CROSSDIM" if from_dim else "CROSSDIS"
        return registry.get_dataset(name)(args)
    return registry.get_dataset(args.dataset)(args)


# ---------------------------------------------------------------------------
# Cross-corpus protocols (MERBench dataloader/crossdis.py + crossdim.py)
# ---------------------------------------------------------------------------

# crossdis evaluates the 4-class intersection (crossdis.py:11-17)
CROSSDIS_EMOS = ("happy", "sad", "neutral", "angry")
CROSSDIS_EMO2IDX = {e: i for i, e in enumerate(CROSSDIS_EMOS)}
# per-dataset raw-label -> common-name maps (crossdis.py dataset_map)
CROSSDIS_MAP = {
    "IEMOCAPFour": {0: "happy", 1: "sad", 2: "neutral", 3: "angry"},
    "IEMOCAPSix": {0: "happy", 1: "sad", 2: "neutral", 3: "angry"},
    "MELD": {0: "angry", 1: "happy", 2: "sad", 3: "neutral"},
    "MER2023": {"neutral": "neutral", "angry": "angry", "happy": "happy",
                "sad": "sad"},
}
DIM_DATASETS = ("CMUMOSI", "CMUMOSEI", "SIMS", "SIMSv2")


class _CrossBase(BaseLoader):
    """Train on args.train_dataset, test on args.test_dataset. Paths resolve
    per dataset from the registry; --features_root/--label_path override the
    TRAIN side, --test_features_root/--test_label_path the TEST side."""

    def _paths(self, dataset, side):
        a = self.args
        override_feat = a.features_root if side == "train" else a.test_features_root
        override_label = a.label_path if side == "train" else a.test_label_path
        if override_feat and override_label:
            return override_feat, override_label
        reg = configure_from_env()
        entry = reg[dataset]
        return (override_feat or entry.features,
                override_label or entry.label)

    def _build_for(self, dataset, side, names, emos, vals):
        a = self.args
        feats_root, _ = self._paths(dataset, side)
        roots = [os.path.join(feats_root, f) if f else None
                 for f in (a.audio_feature, a.text_feature, a.video_feature)]
        return FeatureDataset.build(
            names, emos, vals, *roots,
            feat_type=a.feat_type or "utt", feat_scale=a.feat_scale or 1)


@registry.register_dataset("CROSSDIS")
class CrossDisLoader(_CrossBase):
    """Discrete cross-corpus: filter to the 4 common emotions, re-index,
    train with the source dataset's CV scheme, test on the target's test
    split (crossdis.py:20-127)."""

    output_dim1 = 4
    output_dim2 = 0
    metric_name = "emo"

    def _read_mapped(self, dataset, split, side):
        _, label_path = self._paths(dataset, side)
        archive = np.load(label_path, allow_pickle=True)
        corpus = archive[f"{split}_corpus"].tolist()
        mapping = CROSSDIS_MAP[dataset]
        names, emos = [], []
        for name, label in corpus.items():
            emo = label.get("emo")
            if emo in mapping:
                names.append(name)
                emos.append(CROSSDIS_EMO2IDX[mapping[emo]])
        return names, np.asarray(emos, np.int32), np.zeros(len(names), np.float32)

    def load(self, seed: int = 0):
        a = self.args
        src, tgt = a.train_dataset, a.test_dataset
        train_split = "whole" if src.startswith("IEMOCAP") else "train"
        tr = self._read_mapped(src, train_split, "train")
        train_set = self._build_for(src, "train", *tr)
        if src.startswith("IEMOCAP"):
            folds = _IEMOCAPBase.make_folds(self, tr[0], seed)
        elif src == "MELD":
            ev = self._read_mapped(src, "val", "train")
            names = list(tr[0]) + list(ev[0])
            emos = np.concatenate([tr[1], ev[1]])
            vals = np.concatenate([tr[2], ev[2]])
            train_set = self._build_for(src, "train", names, emos, vals)
            folds = [(np.arange(len(tr[0])), np.arange(len(tr[0]), len(names)))]
        else:
            folds = self.make_folds(tr[0], seed)
        test_split = {"MER2023": "test1", "MELD": "test"}.get(
            tgt, "whole" if tgt.startswith("IEMOCAP") else "test")
        te = self._read_mapped(tgt, test_split, "test")
        test_sets = {"test1": self._build_for(tgt, "test", *te)}
        return train_set, folds, test_sets


@registry.register_dataset("CROSSDIM")
class CrossDimLoader(_CrossBase):
    """Dimensional (valence) cross-corpus: train/val from the source
    dataset's fixed splits, test from the target (crossdim.py:8-55)."""

    output_dim1 = 0
    output_dim2 = 1
    metric_name = "emo"
    calc_results = staticmethod(calc_results_val_sign)

    def _read_for(self, dataset, split, side):
        _, label_path = self._paths(dataset, side)
        return labels_mod.read_names_labels(label_path, split,
                                            debug=bool(self.args.debug))

    def load(self, seed: int = 0):
        a = self.args
        src, tgt = a.train_dataset, a.test_dataset
        tr = self._read_for(src, "train", "train")
        ev = self._read_for(src, "val", "train")
        names = list(tr[0]) + list(ev[0])
        emos = np.concatenate([tr[1], ev[1]])
        vals = np.concatenate([tr[2], ev[2]])
        train_set = self._build_for(src, "train", names, emos, vals)
        folds = [(np.arange(len(tr[0])), np.arange(len(tr[0]), len(names)))]
        te = self._read_for(tgt, "test", "test")
        test_sets = {"test": self._build_for(tgt, "test", *te)}
        return train_set, folds, test_sets
