"""Captions completed over the whole window (a batch's captions count once
its tokens are on the host), host clock."""


def read(run):
    return sum(run.window.units) / run.window.seconds
