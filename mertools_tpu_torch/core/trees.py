"""State-dict checks shared by the CLIs (the port's copy of
``mertools_tpu/core/trees.py:check_tree_like`` for flat state dicts)."""

from __future__ import annotations


def check_tree_like(restored: dict, reference: dict, source: str) -> None:
    """A restored state dict must match the reference architecture (the
    same keys and tensor shapes), so a wrong checkpoint fails here with a
    clear message instead of at the first forward."""
    if set(restored) != set(reference):
        raise ValueError(
            f"{source}: checkpoint tree does not match the selected "
            f"model architecture (structure mismatch)")
    bad = [(tuple(restored[k].shape), tuple(reference[k].shape))
           for k in sorted(reference)
           if tuple(restored[k].shape) != tuple(reference[k].shape)]
    if bad:
        raise ValueError(
            f"{source}: checkpoint leaf shapes do not match the selected "
            f"model architecture (e.g. {bad[0][0]} vs {bad[0][1]})")
