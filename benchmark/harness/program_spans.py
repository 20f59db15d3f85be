"""The program's own spans, as the per-layer metrics with ``source``
``program_span`` read them: ``srbh_tpu_torch.utils.profiler.spans()``, the
spans the port recorded while a profiler recorded (in a traced run, the
profiled stretches).

A reader picks the roots of its cell (``predict.step`` with no parent in
serving, ``gan.step``, ``predict.city``), leaves out the oldest, reduces
each other root's tree to one number, and reports the median over them.
Every driver profiles one unit in a warm-up stretch before the timed
window (a request, a step, a whole city): that unit is the oldest root.
Where the port records no spans (a checkout whose profiler has no
``spans()``) or no other root is there, it reads ``None``.

These spans are recorded under the profiler, whose host cost roughly
doubles the program's host side: a host time reads higher than the same
code runs unprofiled, and so does the stream time between a span's CUDA
events wherever the host, not the card, sets the pace.
"""
from __future__ import annotations

import statistics


def recorded():
    """The port's spans, or ``None`` where the port records none."""
    from srbh_tpu_torch.utils import profiler
    read = getattr(profiler, "spans", None)
    return None if read is None else read()


def trees(spans: list, root: str) -> list:
    """For each span named ``root`` with no parent, the list of the spans
    under it (at any depth), oldest first."""
    top, out = [], {}
    for i, s in enumerate(spans):
        top.append(i if s["parent"] is None else top[s["parent"]])
        if top[i] == i:
            if s["name"] == root:
                out[i] = []
        elif top[i] in out:
            out[top[i]].append(s)
    return list(out.values())


def host(s: dict) -> float:
    """A span's host seconds."""
    return (s["t1_ns"] - s["t0_ns"]) / 1e9


def own(s: dict) -> float:
    """A span's host seconds less its children's."""
    return s["self_ns"] / 1e9


def device(s: dict):
    """A span's device milliseconds (``None`` where it has none)."""
    return s["device_ms"]


def median_over(root: str, per_tree):
    """The median over the roots named ``root``, but the oldest (the
    warm-up stretch's), of ``per_tree(spans under the root)``, leaving out
    the roots it gives ``None``; ``None`` where none is left."""
    spans = recorded()
    if not spans:
        return None
    values = [v for v in map(per_tree, trees(spans, root)[1:])
              if v is not None]
    return statistics.median(values) if values else None


def total(names, value):
    """``per_tree``: the sum of ``value(span)`` over the spans named in
    ``names``; ``None`` where the tree has none, or one reads ``None``."""
    names = {names} if isinstance(names, str) else set(names)

    def per_tree(kids):
        got = [value(s) for s in kids if s["name"] in names]
        return None if not got or None in got else sum(got)

    return per_tree


def per_unit(name, value):
    """``per_tree``: the mean of ``value(span)`` over the spans named
    ``name`` (one a batch); ``None`` where the tree has none."""
    def per_tree(kids):
        got = [value(s) for s in kids if s["name"] == name]
        return sum(got) / len(got) if got else None

    return per_tree
