"""Trees of tensors: nested tuples (NamedTuples included), lists and dicts
whose leaves are tensors or None, walked in field order."""

from __future__ import annotations

import torch


def leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in leaves(v)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def unflatten(template, values: list):
    """``template``'s structure with ``values`` as its leaves, in order."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def clone(tree):
    return unflatten(tree, [t.clone() for t in leaves(tree)])


def transplant(tree, template):
    """The leaves of ``tree`` (the program's state) cloned into the
    structure of ``template`` (the reference's state of the same layout)."""
    got, want = leaves(tree), leaves(template)
    if len(got) != len(want):
        raise ValueError(f"{len(got)} leaves for a template of {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise ValueError(f"leaf {i}: {g.dtype} {tuple(g.shape)} for {w.dtype} "
                             f"{tuple(w.shape)}")
    return unflatten(template, [g.clone() for g in got])


def max_gap(a, b) -> float:
    """The largest |a - b| over the leaves of two trees of one layout, in
    float64; inf where either side is not finite."""
    worst = 0.0
    for x, y in zip(leaves(a), leaves(b), strict=True):
        x, y = x.double(), y.double()
        if not (bool(torch.isfinite(x).all()) and bool(torch.isfinite(y).all())):
            return float("inf")
        if x.numel():
            worst = max(worst, float((x - y).abs().max()))
    return worst


def per_instance_finite(tree, batch: int) -> torch.Tensor:
    """(batch,) bool: every leaf of the instance finite."""
    ok = None
    for t in leaves(tree):
        if not t.is_floating_point():
            continue
        f = torch.isfinite(t.reshape(batch, -1)).all(-1)
        ok = f if ok is None else ok & f
    return ok
