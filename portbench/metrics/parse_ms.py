"""Producer-thread milliseconds a batch inside next() of the sample's
batch iterator: native gunzip and parse, and for mate pairs the
interleave."""


def read(ctx):
    ms = ctx["spans"]["parse_ms"]
    return sum(ms) / len(ms) if ms else None
