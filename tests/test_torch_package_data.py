"""What the port reads from its own package directory at run time is
packaged: every source the kernel build compiles (``csrc/*.cu`` and the
shared ``csrc/*.cuh``), the fusion trainer's hyperparameter spaces
(``train/model_tune.yaml``), the Haar evaluator's source
(``native/merhaar.cpp``) and the face frontend's two cascades
(``ops/cascades/*.xml``) match a pattern of pyproject.toml's
``[tool.setuptools.package-data]``."""

import fnmatch
import os
import tomllib
from pathlib import Path

from mertools_tpu_torch.cli import main_release
from mertools_tpu_torch.ops import _kernels, viola_jones

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "mertools_tpu_torch"


def _patterns() -> list[str]:
    with open(REPO / "pyproject.toml", "rb") as f:
        cfg = tomllib.load(f)
    return cfg["tool"]["setuptools"]["package-data"]["mertools_tpu_torch"]


def _packaged(path: Path) -> bool:
    rel = path.resolve().relative_to(PKG).as_posix()
    return any(fnmatch.fnmatch(rel, p) for p in _patterns())


def test_every_kernel_source_is_package_data():
    sources = _kernels._sources()
    assert {s.suffix for s in sources} == {".cu", ".cuh"}
    missing = [s.name for s in sources if not _packaged(s)]
    assert not missing, missing


def test_the_tune_yaml_is_package_data():
    tune = Path(os.path.normpath(main_release._TUNE_YAML))
    assert tune.exists()
    assert _packaged(tune)
    assert not _packaged(PKG / "train" / "loop.py")


def test_the_haar_source_and_cascades_are_package_data(monkeypatch):
    monkeypatch.delenv("MERTOOLS_CASCADE_DIR", raising=False)
    assert _packaged(viola_jones.HAAR_SOURCE)
    for name in (viola_jones.FRONTALFACE, viola_jones.EYE):
        assert _packaged(Path(viola_jones.find_cascade(name)))
