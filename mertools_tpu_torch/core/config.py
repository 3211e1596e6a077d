"""Dataset path registry (port of ``mertools_tpu/core/config.py:51-141``).

What ``--dataset`` needs: :class:`DatasetPaths`, :class:`PathRegistry`, the
global :data:`REGISTRY`, :func:`configure_from_env` and
:func:`resolve_dataset_args`. The registry YAML and its environment variable
(``$MERTOOLS_TPU_CONFIG``) are the JAX package's, so one file serves both.
PyYAML is imported only when a registry file is read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class DatasetPaths:
    """Normalized-layout paths for one dataset (reference MERBench/config.py)."""

    root: str
    video: str = ""
    audio: str = ""
    openface_face: str = ""
    features: str = ""
    transcriptions: str = ""
    label: str = ""

    def __post_init__(self):
        defaults = {
            "video": "video",
            "audio": "audio",
            "openface_face": "openface_face",
            "features": "features",
            "transcriptions": "transcription.csv",
            "label": "label-6way.npz",
        }
        for name, rel in defaults.items():
            if not getattr(self, name):
                setattr(self, name, os.path.join(self.root, rel))


@dataclass
class PathRegistry:
    """Maps dataset name -> :class:`DatasetPaths` plus global tool paths."""

    datasets: dict[str, DatasetPaths] = field(default_factory=dict)
    saved_root: str = "./saved"

    def register(self, name: str, root: str, **kw) -> DatasetPaths:
        paths = DatasetPaths(root=root, **kw)
        self.datasets[name] = paths
        return paths

    def __getitem__(self, name: str) -> DatasetPaths:
        return self.datasets[name]

    def __contains__(self, name: str) -> bool:
        return name in self.datasets

    @classmethod
    def from_yaml(cls, path: str) -> "PathRegistry":
        import yaml

        with open(path, "r") as f:
            raw = yaml.safe_load(f) or {}
        reg = cls(saved_root=raw.get("saved_root", "./saved"))
        for name, spec in raw.get("datasets", {}).items():
            if isinstance(spec, str):
                reg.register(name, spec)
            else:
                reg.register(name, **spec)
        return reg


# Global default registry; CLIs populate it from a YAML or env var.
REGISTRY = PathRegistry()


def resolve_dataset_args(args, dataset_attr: str = "dataset",
                         **arg_to_field) -> None:
    """run.sh compatibility: fill CLI path args left as None from the
    registry entry named by ``--dataset``. Explicit dirs always win; raises
    SystemExit if a path is still missing."""
    ds = getattr(args, dataset_attr, None)
    if ds is not None:
        reg = configure_from_env()
        if ds not in reg:
            raise SystemExit(
                f"--dataset={ds} is not in the path registry "
                f"(set $MERTOOLS_TPU_CONFIG or pass explicit dirs)")
        for arg, fieldname in arg_to_field.items():
            if getattr(args, arg, None) is None:
                setattr(args, arg, getattr(reg[ds], fieldname))
    missing = [a for a in arg_to_field if getattr(args, a, None) is None]
    if missing:
        raise SystemExit(
            f"missing {', '.join('--' + m for m in missing)} "
            f"(pass them explicitly or use --dataset with a registry)")


def configure_from_env() -> PathRegistry:
    """Load the path registry from $MERTOOLS_TPU_CONFIG if set."""
    cfg = os.environ.get("MERTOOLS_TPU_CONFIG")
    if cfg and os.path.exists(cfg):
        global REGISTRY
        REGISTRY = PathRegistry.from_yaml(cfg)
    return REGISTRY
