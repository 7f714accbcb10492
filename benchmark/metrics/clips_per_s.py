"""Clips embedded over the whole window (a batch's clips count once their
embeddings are on the host), host clock."""


def read(run):
    return sum(run.window.units) / run.window.seconds
