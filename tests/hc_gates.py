"""The rule that holds one run of the port's handcrafted sets to another:
a store column by column (:func:`hc_gate`), and IS10's and IS13's utterance
functionals with an account of each column off its allowance
(:func:`hc_explain`). The CPU tests hold the port to the JAX package by it,
and ``chip_smoke.py``'s phase 21 holds the card to the CPU by it. It imports
neither JAX nor the JAX package: a reference side is given as its engine."""

from __future__ import annotations

import math

import numpy as np

HC_RAGGED_TOL = 1e-5   # a ragged bucket vs each clip alone, of max |clip|
# Columns held otherwise, as in tests/test_torch_{opensmile_is09,egemaps}.py:
# IS09's skewness and kurtosis on their own unit scale (|moment| floored at
# 1: x - mean cancels on a steady contour), and eGeMAPS's formant widths
# (an ill-conditioned curvature clamped at a floor, ROADMAP C3): the frame
# column F1bandwidth at HC_BW_TOL of its max on all but HC_BW_OFF of its
# nonzero frames, the six width functionals at HC_BW_UTT_TOL.
HC_BW_TOL, HC_BW_OFF, HC_BW_UTT_TOL = 1e-2, 0.03, 5e-2

# IS10 and IS13 utterance columns: a functional that counts frames past a
# threshold, splits them by the sign of a difference or picks peaks is a
# decision; the order-5 LP of IS13, the moments of a steady contour and the
# mean of a delta spanning 10^7 are ill-conditioned. So two float32 runs of
# one chain can part by more than the tolerance on such a column though
# their contours agree within it. ``hc_explain`` holds a column off the
# allowance to one of four accounts, each printed:
# - "contours": the reference side's engine, fed this side's contours, gives
#   this side's value within the allowance (the decisions follow the
#   contours: the engines agree at this entry);
# - "lp", for the LP columns (HC_LP_FUNCS) and no other account but
#   "contours": within HC_LP_SLACK kappa eps32 max(1, |a|) of the
#   reference, kappa the condition number of the order-5 Toeplitz system of
#   its contour and a its LP coefficients;
# - "tie": an upleveltime threshold within HC_TIE of the contour's max |x|
#   of one of its frames (a float32 threshold min + q range is a few ulps
#   of max |x| off);
# - "rounding", only where the reference side's engine runs in float64 too
#   (the card held to the port on the CPU): this side's value no further
#   from that float64 value on its contours than HC_ROUND_SLACK times the
#   reference's own float32 error on either side's contours.
# The readings behind each constant are in PERF.md section 7.
HC_LP_FUNCS = ("lpgain", "lpc0", "lpc1", "lpc2", "lpc3", "lpc4")
HC_LP_SLACK = 8
HC_ROUND_SLACK = 4
HC_TIE = 1e-6


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def hc_columns(fs: str, level: str):
    """(columns that must be equal, {column: scale floor}, width columns)
    of a set's store at a level: IS09 FRAME F0 (voicing and lag), UTT
    maxPos / minPos and the moments; eGeMAPS FRAME F0 and F1bandwidth, UTT
    the width functionals."""
    if fs == "IS09" and level == "UTTERANCE":
        return ([c * 12 + f for c in range(32) for f in (3, 4)],
                {c * 12 + f: 1.0 for c in range(32) for f in (10, 11)}, ())
    if fs == "IS09":
        return [3], {}, ()
    if fs == "eGeMAPS":
        from mertools_tpu_torch.ops import egemaps as te

        if level == "UTTERANCE":
            return [], {}, tuple(i for i, n in enumerate(te.EGEMAPS_NAMES) if "bandwidth" in n)
        return [te.LLD_NAMES.index("F0semitone")], {}, (te.LLD_NAMES.index("F1bandwidth"),)
    return [], {}, ()


def hc_stack(fs: str, level: str, feats: dict, names) -> np.ndarray:
    """A store's clips as one (rows, D) array: the UTT vectors of the
    openSMILE sets stacked, every other store's frames concatenated."""
    rows = [feats[n] for n in names]
    return np.stack(rows) if fs in ("IS09", "eGeMAPS", "IS10", "IS13") and level == "UTTERANCE" \
        else np.concatenate(rows)


def hc_gate(fs: str, level: str, got: dict, want: dict, tol: float, what: str,
            scale_floor: float = 0.0) -> float:
    """Holds ``got`` to ``want`` (name -> store array) column by column:
    within ``tol`` of each column's max |want| (floored at ``scale_floor``
    and as ``hc_columns`` says) or 1e-6, discrete columns equal, widths as
    HC_BW_*. Returns the worst error over its allowance (<= 1); fails
    otherwise."""
    names = sorted(want)
    for n in names:
        check(got[n].shape == want[n].shape, f"{what} {fs} {level} {n}: {got[n].shape} "
              f"vs {want[n].shape}")
    g, w = hc_stack(fs, level, got, names), hc_stack(fs, level, want, names)
    equal, floors, widths = hc_columns(fs, level)
    for c in equal:
        check(np.array_equal(g[:, c], w[:, c]), f"{what} {fs} {level}: column {c} differs")
    worst = 0.0
    for c in range(w.shape[1]):
        err = np.abs(g[:, c] - w[:, c])
        scale = max(float(np.abs(w[:, c]).max()), floors.get(c, 0.0), scale_floor)
        if c in widths and level == "FRAME":
            allowed = max(HC_BW_TOL * scale, 1e-6)
            off = int((err > allowed).sum())
            check(off <= HC_BW_OFF * max(int((w[:, c] != 0).sum()), 1),
                  f"{what} {fs} {level}: width column {c} off on {off} frames")
            err = err[err <= allowed]
        else:
            allowed = max((HC_BW_UTT_TOL if c in widths else tol) * scale, 1e-6)
        worst = max(worst, float(err.max(initial=0.0)) / allowed)
    check(worst <= 1.0, f"{what} {fs} {level}: {worst:.3f} of the allowance")
    return worst


def chain(fs: str):
    """The port's IS10 or IS13 module (``functional_blocks``,
    ``block_functionals``, the names)."""
    from mertools_tpu_torch.ops import opensmile_is10, opensmile_is13

    return opensmile_is10 if fs == "IS10" else opensmile_is13


def port_engine(fs: str, float64: bool = False):
    """The port's functional engine of a set as ``hc_explain`` takes one:
    (contours, mask, functional names) -> numpy (B, D * n_funcs), in the
    contours' dtype or in float64."""
    mod = chain(fs)

    def engine(x, mask, funcs):
        return mod.block_functionals(x.double() if float64 else x, mask, funcs).numpy()
    return engine


def hc_kappa(x: np.ndarray, m: np.ndarray) -> float:
    """Condition number of the order-5 Toeplitz system IS13's LP
    functionals solve for the masked contour ``x`` (F,), in float64."""
    xm = x.astype(np.float64) * m
    F = len(xm)
    r = np.array([np.sum(xm[k:] * xm[: max(F - k, 0)]) for k in range(6)])
    r = r / max(r[0], 1e-12)
    return float(np.linalg.cond(r[np.abs(np.subtract.outer(np.arange(5), np.arange(5)))]))


def hc_tie_margin(x: np.ndarray, func: str) -> float:
    """For an ``upleveltime<q>`` functional of the valid contour values
    ``x``: the least distance of a value from the threshold min + q/100
    range, over max |x| (inf for any other functional)."""
    if not func.startswith("upleveltime") or not len(x):
        return math.inf
    x = x.astype(np.float64)
    thr = x.min() + int(func[len("upleveltime"):]) / 100.0 * (x.max() - x.min())
    return float(np.abs(x - thr).min() / max(np.abs(x).max(), 1e-30))


def hc_block_accounts(got: np.ndarray, want: np.ndarray, got_block, want_block, engine,
                      allowed: np.ndarray, what: str, engine64=None) -> list:
    """The accounts of one block's entries off ``allowed`` (B, width): [(clip,
    column in the block, account, detail)], the detail an entry's distance
    in its account's unit, which the account holds to its slack (1 for
    "contours", HC_LP_SLACK, HC_TIE for a tie's margin, HC_ROUND_SLACK);
    fails on any other entry. ``engine`` is the reference side's,
    ``engine64`` its float64 one (None: no "rounding" account)."""
    (xg, mg, funcs), (xw, mw, _) = got_block, want_block
    hits = np.argwhere(np.abs(got - want) > allowed)
    if not len(hits):
        return []
    other = engine(xg, mg, funcs)
    if engine64 is not None:
        e64g, e64w = engine64(xg, mg, funcs), engine64(xw, mw, funcs)
    xw_np, mw_np = np.asarray(xw), np.asarray(mw)
    nf, out = len(funcs), []
    for b, j in hits:
        d, f = divmod(int(j), nf)
        func = funcs[f]
        # account -> (distance, its unit, the slack it is held to)
        acc = {"contours": (abs(float(got[b, j] - other[b, j])), allowed[b, j], 1.0)}
        if func in HC_LP_FUNCS:
            base = d * nf
            lpc = want[b, base + funcs.index("lpc0"): base + funcs.index("lpc4") + 1]
            acc["lp"] = (abs(float(got[b, j]) - float(want[b, j])),
                         hc_kappa(xw_np[b, :, d], mw_np[b]) * 2.0 ** -24
                         * max(1.0, float(np.abs(lpc).max())), HC_LP_SLACK)
        else:
            acc["tie"] = (hc_tie_margin(xw_np[b, mw_np[b], d], func), 1.0, HC_TIE)
            if engine64 is not None:
                est = max(abs(want[b, j] - e64w[b, j]), abs(other[b, j] - e64g[b, j]))
                acc["rounding"] = (abs(float(got[b, j] - e64g[b, j])),
                                   max(est, allowed[b, j] / HC_ROUND_SLACK), HC_ROUND_SLACK)
        how = next((k for k, (v, unit, slack) in acc.items() if v <= slack * unit), None)
        check(how is not None, f"{what}: {func} of contour {d} on clip {b}: {got[b, j]!r} vs "
              f"{want[b, j]!r} (allowed {allowed[b, j]:.3g}), no account")
        v, unit, _ = acc[how]
        out.append((int(b), int(j), how, v / unit))
    return out


def hc_explain(fs: str, got: np.ndarray, want: np.ndarray, got_blocks, want_blocks,
               engine, tol: float, what: str, engine64=None):
    """Holds IS10 / IS13 utterance functionals ``got`` (B, D) to ``want``:
    each column within ``tol`` of its max |want| (or 1e-6), or off it on a
    clip for one of the accounts above. ``engine(x, mask, funcs)`` is the
    functional engine of the ``want`` side and ``engine64`` its float64 one
    (None where it has none); the blocks are each side's contours as the
    port's ``functional_blocks`` gives them, whose masks must be equal and
    contours within ``tol`` of each contour's max on the valid frames.
    Returns (the worst column over its allowance, [(name, clip, account,
    got, want, detail)]); fails on any other column."""
    names = chain(fs).IS10_NAMES if fs == "IS10" else chain(fs).IS13_NAMES
    check(got.shape == want.shape == (want.shape[0], len(names)),
          f"{what} {fs}: {got.shape} vs {want.shape}")
    unit = np.array([n.endswith(("_skewness", "_kurtosis")) for n in names], np.float32)
    allowed = np.broadcast_to(np.maximum(tol * np.maximum(np.abs(want).max(0), unit), 1e-6),
                              want.shape)
    off = np.abs(got - want) > allowed
    worst = float((np.abs(got - want) / allowed)[~off].max(initial=0.0))
    explained, col = [], 0
    for gb, wb in zip(got_blocks, want_blocks):
        # the accounts stand on the contours, so they are held first: each
        # block's masks equal, its contours within ``tol`` on valid frames
        xv, mv = np.asarray(wb[0]), np.asarray(wb[1])
        check(np.array_equal(np.asarray(gb[1]), mv), f"{what} {fs}: a block's masks differ")
        scale = np.maximum(tol * np.abs(xv[mv]).max(0, initial=0.0), 1e-6)
        check(bool((np.abs(np.asarray(gb[0])[mv] - xv[mv]) <= scale).all()),
              f"{what} {fs}: contours of the block at column {col} differ past {tol:.0e}")
        width = xv.shape[-1] * len(wb[2])
        sl = slice(col, col + width)
        for b, j, how, detail in hc_block_accounts(got[:, sl], want[:, sl], gb, wb, engine,
                                                   allowed[:, sl], f"{what} {fs}", engine64):
            explained.append((names[col + j], b, how, float(got[b, col + j]),
                              float(want[b, col + j]), detail))
        col += width
    check(not off[:, col:].any(), f"{what} {fs}: a column past the functionals' blocks differs")
    return worst, explained
