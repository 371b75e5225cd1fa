"""Seconds of a sample inside profile.checkpoint.save, every save."""


def read(ctx):
    return ctx["spans"]["checkpoint_s"] if ctx["spans"]["batches"] else None
