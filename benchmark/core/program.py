"""The port's own record of the last traced window: the spans and counters
of its tracer (``upcc_tpu_torch.utils.profiling``), each span with its
unit (a codec call or a training step), parent and times on the host
clock.  A checkout whose port has no tracer gives None, so that a reader
of it finds nothing there and its metric stays out of the line."""


def record():
    """The tracer's last record, or None where the port has no tracer or
    the record is empty."""
    try:
        from upcc_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_record", None)
    if last is None:
        return None
    rec = last()
    if not getattr(rec, "spans", None) and not getattr(rec, "counts", None):
        return None
    return rec


def roots(rec, name):
    """The spans named ``name`` that open a unit."""
    return [s for s in rec.spans if s.unit is not None
            and s.unit[0] == name and s.name == name]


def self_ns(rec, match):
    """Summed self time of the spans whose name ``match(name)`` accepts, in
    ns: each span's length less the part of it that its children cover
    (children on worker threads may overlap)."""
    children = {}
    for s in rec.spans:
        children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    total = 0
    for s in rec.spans:
        if not match(s.name):
            continue
        covered, cur = 0, s.start_ns
        for a, b in sorted(children.get(s.id, ())):
            a, b = max(a, cur), min(b, s.end_ns)
            if b > a:
                covered += b - a
                cur = b
        total += s.end_ns - s.start_ns - covered
    return total


def counter(rec, match):
    """A counter's total over every unit of the record, over the counter
    names ``match(name)`` accepts."""
    return sum(n for c in rec.counts.values() for k, n in c.items()
               if match(k))
