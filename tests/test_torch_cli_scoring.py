"""The port's host-side scoring (ROADMAP A19) against the JAX package on the
same inputs: the OV metrics (MER2024 synonym sets, the emotion-wheel F at
both levels, the overlap rate, label mapping) and the wheel tables read
from .csv and .xlsx; the ``evaluation`` CLI's submissions and scores
(weighted F1 without sklearn, valence MSE); ``main_ov mer2024`` and
``wheel``; ``parity_check``'s store mode, and its judge mode's exit naming
A13."""

import json

import numpy as np
import pytest

from mertools_tpu.cli import evaluation as jeval
from mertools_tpu.cli import main_ov as jov
from mertools_tpu.cli import parity_check as jpc
from mertools_tpu.io import xlsx as jx
from mertools_tpu.ops import ov_metrics as jm
from mertools_tpu_torch.cli import evaluation as teval
from mertools_tpu_torch.cli import main_ov as tov
from mertools_tpu_torch.cli import parity_check as tpc
from mertools_tpu_torch.io import xlsx as tx
from mertools_tpu_torch.ops import ov_metrics as tm
from test_xlsx import _make_xlsx, _n, _s

WHEELS = {"wheel1": {"joy": {"cheerful": ["happy", "amused"], "content": ["satisfied"]},
                     "sadness": {"gloomy": ["down", "sad"]}},
          "wheel2": {"anger": {"rage": ["furious", "angry"]},
                     "joy": {"glad": ["happy", "pleased"]}}}
FMT = {"happy": ["happy"], "joyful": ["happy"], "sad": ["sad"], "down": ["down"],
       "angry": ["angry", "furious"], "pleased": ["pleased"], "calm": ["satisfied"]}
RAW = {k: [k] for k in ("happy", "sad", "down", "angry", "furious", "pleased", "satisfied")}


def _labels(seed=0, n=12):
    rng = np.random.default_rng(seed)
    words = list(FMT) + ["unknown", "Happy"]
    pick = lambda: str(sorted(set(rng.choice(words, size=rng.integers(0, 4)))))  # noqa: E731
    return ({f"c{i}": pick() for i in range(n)}, {f"c{i}": pick() for i in range(n)})


@pytest.mark.parametrize("level", ["level1", "level2"])
def test_wheel_metric_and_overlap_equal_jax(level):
    gt, pred = _labels()
    gt["c0"] = "['happy']"   # at least one sample maps
    args = (gt, pred, WHEELS, FMT, RAW)
    assert tm.wheel_metric_calculation(*args, level=level) == \
        jm.wheel_metric_calculation(*args, level=level)
    wm = tm.wheel_cluster_map(WHEELS["wheel1"], level)
    assert wm == jm.wheel_cluster_map(WHEELS["wheel1"], level)
    for metric in ("case1", "case2", "case3"):
        assert tm.openset_overlap_rate(gt, pred, FMT, RAW, wm, metric) == \
            jm.openset_overlap_rate(gt, pred, FMT, RAW, wm, metric)
        assert tm.map_labels(list(FMT), FMT, RAW, wm, metric) == \
            jm.map_labels(list(FMT), FMT, RAW, wm, metric)


def test_mer2024_metric_and_string_parsing_equal_jax():
    gt, pred = _labels(1)
    syn = {n: [["happy", "joyful"], ["sad", "down"]] for n in gt if gt[n] != "[]"}
    assert tm.mer2024_ov_metric(gt, pred, syn) == jm.mer2024_ov_metric(gt, pred, syn)
    for v in ("['happy', 'sad']", ["a"], "", "angry, calm", float("nan"), "[bad", None):
        assert tm.string_to_list(v) == jm.string_to_list(v)


def test_wheel_tables_from_csv_xlsx_and_npz_equal_jax(tmp_path):
    data = [("joy", "cheerful", "amused"), ("", "", "delighted"),
            ("", "content", "pleased"), ("anger", "rage", "furious")]
    (tmp_path / "wheel1.csv").write_text(
        "level1,level2,level3\n" + "\n".join(",".join(r) for r in data) + "\n")
    strings = ["level1", "level2", "level3"]
    rows = [[_s("A1", 0), _s("B1", 1), _s("C1", 2)]]
    for i, (a, b, c) in enumerate(data):
        cells = []
        for col, val in zip("ABC", (a, b, c)):
            if val:
                strings.append(val)
                cells.append(_s(f"{col}{i + 2}", len(strings) - 1))
        rows.append(cells + [_n(f"D{i + 2}", 2.5)])
    _make_xlsx(str(tmp_path / "wheel2.xlsx"), rows, strings)
    assert tm.load_wheels(str(tmp_path)) == jm.load_wheels(str(tmp_path))
    assert set(tm.load_wheels(str(tmp_path))) == {"wheel1", "wheel2"}
    p = str(tmp_path / "wheel2.xlsx")
    assert tx.read_xlsx_records(p) == jx.read_xlsx_records(p)
    assert tx.read_xlsx_rows(p) == jx.read_xlsx_rows(p)
    tm.save_wheel_mapping(str(tmp_path / "m.npz"), FMT, RAW, WHEELS)
    assert tm.load_wheel_mapping(str(tmp_path / "m.npz")) == \
        jm.load_wheel_mapping(str(tmp_path / "m.npz"))


@pytest.mark.parametrize("valence", [False, True])
def test_evaluation_cli_equals_jax(tmp_path, valence):
    from mertools_tpu_torch.core.globals_mer import EMOS_MER

    rng = np.random.default_rng(2)
    names = [f"c{i}" for i in range(30)]
    extra = {"valpreds": rng.normal(size=30)} if valence else {}
    np.savez_compressed(tmp_path / "r.npz", emoprobs=rng.random((30, 6)), names=names,
                        **extra)
    gt = tmp_path / "gt.csv"
    head = "name,discrete" + (",valence" if valence else "")
    gt.write_text(head + "\n" + "\n".join(
        f"{n},{EMOS_MER[rng.integers(6)]}" + (f",{rng.normal():.3f}" if valence else "")
        for n in names) + "\n")
    for mod, tag in ((jeval, "j"), (teval, "t")):
        mod.main(["submission", f"--result_npz={tmp_path / 'r.npz'}",
                  f"--save_csv={tmp_path / tag}.csv"])
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    want = jeval.main(["score", f"--label_csv={gt}", f"--submission_csv={tmp_path / 'j.csv'}"])
    got = teval.main(["score", f"--label_csv={gt}", f"--submission_csv={tmp_path / 't.csv'}"])
    assert len(got) == (4 if valence else 2)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_main_ov_mer2024_and_wheel_equal_jax(tmp_path):
    gt, pred = _labels(3)
    gt = {n: v if v != "[]" else "['happy']" for n, v in gt.items()}   # gt is never empty
    (tmp_path / "gt.csv").write_text(
        "name,openset\n" + "\n".join(f'{n},"{v}"' for n, v in gt.items()) + "\n")
    np.savez_compressed(tmp_path / "pred.npz", filenames=list(pred),
                        fileitems=list(pred.values()))
    syn = tmp_path / "syn"
    syn.mkdir()
    for i, n in enumerate(gt):
        groups = [["happy", "joyful"], ["sad", "down"]]
        np.save(syn / f"{n}.npy", str(groups) if i % 2 else np.array(groups, dtype=object),
                allow_pickle=True)
    (tmp_path / "w.json").write_text(json.dumps(
        {"wheels": WHEELS, "format_mapping": FMT, "raw_mapping": RAW}))
    for argv in (["mer2024", f"--synonym_root={syn}"],
                 ["wheel", f"--wheel_json={tmp_path / 'w.json'}"]):
        argv = argv + [f"--gt_csv={tmp_path / 'gt.csv'}",
                       f"--pred_npz={tmp_path / 'pred.npz'}"]
        assert tov.main(argv) == jov.main(argv)


def test_parity_check_store_mode_equals_jax_and_judge_mode_exits(tmp_path):
    ref, ours = tmp_path / "ref", tmp_path / "ours"
    ref.mkdir()
    ours.mkdir()
    rng = np.random.default_rng(4)
    for i in range(4):
        x = rng.normal(size=(7,)).astype(np.float32)
        np.save(ref / f"c{i}.npy", x)
        np.save(ours / f"c{i}.npy", x + (1e-5 if i < 3 else 0.0))
    np.save(ours / "only_ours.npy", np.zeros(3, np.float32))
    argv = [f"--reference_store={ref}", f"--our_store={ours}", "--tol=1e-3"]
    assert tpc.main(argv) == jpc.main(argv)
    np.save(ours / "c0.npy", np.load(ref / "c0.npy") + 0.5)
    with pytest.raises(SystemExit):
        tpc.main(argv)
    with pytest.raises(SystemExit, match="A13"):
        tpc.main(["--judge=videochatgpt", "--reference_responses=r.csv"])
